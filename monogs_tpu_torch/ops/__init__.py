"""Core math on torch tensors: SE(3), spherical harmonics, image masks,
tracking losses and count sketching."""
