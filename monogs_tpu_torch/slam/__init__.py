"""Frame containers and camera tracking."""
