from .datasets import load_dataset  # noqa: F401
from .synthetic import (  # noqa: F401
    SyntheticDataset, make_synthetic_scene, orbit_pose, tum_like_amps,
)
