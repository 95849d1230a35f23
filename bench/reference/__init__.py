"""Plain float32 PyTorch references of each model family, one module a
family, importing nothing of the program under test."""
