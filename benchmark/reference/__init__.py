"""The plain reference that decides a run's ``correct``: plain PyTorch and NumPy,
importing nothing of the measured program (``dream_tpu_torch``) and nothing of JAX.

Frozen copies of the published equations: the two belief-map networks
(:mod:`.models`), the flax msgpack reader (:mod:`.msgpack`), the batch
processor, loss and optimizer (:mod:`.train`), the peak decode and coordinate
maps (:mod:`.decode`) and the PnP solve with ADD (:mod:`.pnp`).
"""
