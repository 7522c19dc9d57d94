"""Model configuration, layers and the dense decoder."""
