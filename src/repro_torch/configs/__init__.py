from repro_torch.configs.base import (  # noqa: F401
    ASSIGNED_ARCHS,
    ArchConfig,
    MoEConfig,
    SHAPES,
    SSMConfig,
    ShapeSpec,
    all_archs,
    dryrun_cells,
    get_arch,
    skipped_cells,
)
from repro_torch.configs.tgn_gdelt import GNN_MODELS, GNNConfig  # noqa: F401
