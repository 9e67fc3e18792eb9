"""dream_tpu_torch: the PyTorch/CUDA port of dream_tpu for NVIDIA Hopper.

A second package beside ``dream_tpu`` (the JAX reference, left as it is),
with the same module names so each counterpart is easy to find:

- ``dream_tpu_torch.utils``     -- resolution algebra, YAML reading
- ``dream_tpu_torch.ops``       -- preprocessing, coordinate affines, belief
                                   map decoding (CUDA score kernel), PnP
- ``dream_tpu_torch.models``    -- the vgg-Q hourglass in NCHW
- ``dream_tpu_torch.checkpoint``-- flax msgpack reader, weight mapping
- ``dream_tpu_torch.network``   -- the inference facade (DreamNetwork)
- ``dream_tpu_torch.analysis``  -- PCK/ADD metrics, in-memory evaluation
- ``dream_tpu_torch.data``      -- in-memory synthetic frames

It imports torch, numpy, scipy and the standard library only, never jax or
dream_tpu.  Importing it builds nothing: the CUDA kernel is compiled with
nvcc on its first launch.
"""

__version__ = "0.1.0"
