"""The plain reference of the benchmark: PyTorch from the published
equations, float32 with TF32 off, or a control's lower precision. It
imports nothing of the program under test."""
