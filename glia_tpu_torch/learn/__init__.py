from .dnf import monotonic_dnf, relaxed_monotonic_dnf, unique_dnf
from .optim import adaptive_gd
from .predict import (
    feature_minmax,
    predict_logsig,
    predict_mlp2,
    predict_rf,
    rescale_features,
)
from .samplers import ClassBatchSampler, UniformBatchSampler
from .sshmt import SshmtDefaults, make_energy, train_sshmt
