"""Device resolution and numpy <-> torch conversion."""
