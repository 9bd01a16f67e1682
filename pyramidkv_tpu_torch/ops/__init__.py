"""Plain PyTorch ops of the port: pooling, scoring, selection, attention."""
