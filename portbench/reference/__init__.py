"""The benchmark's plain reference: a frozen copy of the PyTorch port's
modules (encoders, decoder, losses, optimizer) with every hand-written
kernel replaced by its plain PyTorch version, computed in float32 with
TF32 off, and the control's lower precisions (`precision.py`).

It imports nothing of the port, of `jax` or of the JAX package, and takes
no weights from the program: `portbench/weights.py` makes them from the
seed and hands the same to both sides.
"""
