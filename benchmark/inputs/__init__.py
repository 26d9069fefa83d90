"""The inputs' recipes: a frozen copy of the synthetic EM generator, and
the section the cell runs with its boundary maps.  Each copy names the
file and the commit it was copied from."""
