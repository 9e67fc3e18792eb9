"""dream_tpu_torch: the PyTorch/CUDA port of dream_tpu for NVIDIA Hopper.

A second package beside ``dream_tpu`` (the JAX reference, left as it is),
with the same module names so each counterpart is easy to find:

- ``dream_tpu_torch.utils``     -- resolution algebra, YAML reading, PNG
                                   codec, NDDS dataset discovery
- ``dream_tpu_torch.ops``       -- preprocessing, coordinate affines, belief
                                   map decoding (CUDA score kernel), PnP,
                                   the augmentation warp (CUDA warp kernel),
                                   the int8 3x3 conv (CUDA int8 conv kernel)
- ``dream_tpu_torch.models``    -- the vgg-Q hourglass in NCHW, its
                                   quantization (calibration, QAT) and int8
                                   inference chain
- ``dream_tpu_torch.checkpoint``-- flax msgpack reader and writer, weight and
                                   calibration mapping
- ``dream_tpu_torch.network``   -- the facade (DreamNetwork): inference,
                                   training, int8 inference
- ``dream_tpu_torch.analysis``  -- PCK/ADD metrics, evaluation in memory and
                                   of NDDS datasets with its reports
- ``dream_tpu_torch.data``      -- synthetic frames in memory and on disk,
                                   NDDS datasets and loaders, the batch
                                   processor and augmentation
- ``dream_tpu_torch.cli``       -- the command-line entry points: datasets,
                                   training, dataset evaluation

It imports torch, numpy, scipy and the standard library only, never jax or
dream_tpu.  Importing it builds nothing: each CUDA kernel is compiled with
nvcc on its first launch.
"""

__version__ = "0.1.0"
