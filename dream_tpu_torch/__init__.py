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
- ``dream_tpu_torch.serve``     -- the HTTP pose server and its debug
                                   streams; ``export``: torch.export artifacts
- ``dream_tpu_torch.visualize`` -- keypoint overlays, belief-map colormaps,
                                   mosaics, the pose triad (OpenCV's, Pillow's
                                   and matplotlib's algorithms carried in
                                   ``utils/raster.py``, ``utils/resample.py``
                                   and ``utils/colormaps.py``)
- ``dream_tpu_torch.parallel``  -- the (data, model) mesh of ranks over
                                   process groups, channel-split convs, the
                                   multistage cascade as a GPipe pipeline
- ``dream_tpu_torch.add_plots``, ``oks_plots`` -- ADD and PCK curves, drawn
                                   by the port's line-chart renderer
                                   (``utils/plot.py``)
- ``dream_tpu_torch.cli``       -- the command-line entry points: datasets,
                                   training (one device or a mesh of ranks),
                                   dataset evaluation, training analysis,
                                   single-image and video inference, serving,
                                   export

It imports torch, numpy, scipy and the standard library only, never jax,
dream_tpu, cv2, PIL, matplotlib or pandas.  Importing it builds nothing: each CUDA
kernel is compiled with nvcc on its first launch.  The top-level modules
load on first access (``dream_tpu_torch.visualize``), as in ``dream_tpu``.
"""

import importlib

__version__ = "0.1.0"

_LAZY_MODULES = ("add_plots", "analysis", "export", "network", "oks_plots", "parallel", "serve",
                 "visualize")


def __getattr__(name):
    if name in _LAZY_MODULES:
        return importlib.import_module(f"dream_tpu_torch.{name}")
    raise AttributeError(f"module 'dream_tpu_torch' has no attribute '{name}'")
