"""Frozen copies of the port's host stages that make the cell's inputs
(glia_tpu_torch at commit 28cc36d): the watershed (C++) and the RAG.  They
import nothing of the program; the benchmark builds its own copy of the
C++ watershed."""
