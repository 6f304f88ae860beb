"""Video-clip datasets of the port."""
