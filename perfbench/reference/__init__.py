"""The plain reference that decides ``correct``: plain PyTorch, float32,
independent of the measured program."""
