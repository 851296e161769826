"""The plain reference: float32 PyTorch, no kernel, no cache, nothing of
the port.  ``common`` holds what the model files share; ``follow`` drives
a model file through the cell's first steps."""
