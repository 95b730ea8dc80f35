"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy only: it imports nothing of the program
(``repro_torch``), of the JAX package (``repro``) or of JAX, and takes
nothing the program made.  It reads the raw files a cell's set-up wrote
(the shard files and ``production.json`` of the produced store), decodes
them itself (``zfp.py``, a frozen copy of the plain decode), and trains its
own surrogate (``surrogate.py``) from the benchmark's initial weights and
batch order.
"""
