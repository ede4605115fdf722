from .synthetic import SyntheticDataset, make_synthetic_scene, orbit_pose  # noqa: F401
