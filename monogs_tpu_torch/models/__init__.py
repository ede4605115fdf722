"""The map: fixed-capacity Gaussian state with its Adam moments, and
keyframe insertion."""
