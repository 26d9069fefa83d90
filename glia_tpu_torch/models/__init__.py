from .ensemble import ThresholdEnsemble, distribute
from .forest import (
    ForestModel,
    ForestTables,
    forest_votes,
    predict_label_fraction,
    predict_votes_np,
    train_forest,
)
from .mlp import MLP2, append_bias, logsig_forward, mlp2_dim, mlp2_forward, mlp2_init
from .rf_legacy import (load_legacy_forest, read_legacy_model,
                        save_legacy_forest, write_legacy_model)
