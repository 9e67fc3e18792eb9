"""pip package for dream_tpu (parity: reference setup.py:13-32)."""

import re

from setuptools import find_packages, setup

with open("dream_tpu/__init__.py") as f:
    version = re.search(r'__version__ = "(.*?)"', f.read()).group(1)

setup(
    name="dream_tpu",
    version=version,
    description=(
        "TPU-native camera-to-robot pose estimation: belief-map keypoint "
        "regression + on-device PnP (JAX/Flax/Pallas rebuild of the DREAM "
        "pipeline)"
    ),
    packages=find_packages(
        include=["dream_tpu", "dream_tpu.*", "dream_tpu_torch", "dream_tpu_torch.*"]
    ),
    package_data={"dream_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "pyyaml",
        "pillow",
    ],
    extras_require={
        "viz": ["matplotlib", "opencv-python", "pandas", "webcolors"],
        "test": ["pytest", "scipy", "opencv-python"],
    },
)
