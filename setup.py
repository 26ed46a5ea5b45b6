"""Package setup: `pip install -e .` -> `kbbq-tpu` console script.

The native IO codec (kbbq_tpu/io/native) builds lazily via make on first
use; no build step is required here (and no pybind11 — ctypes bindings).
"""

from setuptools import find_packages, setup

setup(
    name="kbbq-tpu",
    version="0.1.0",
    description=("Reference-free base quality score recalibration "
                 "(kbbq capabilities, JAX/XLA design)"),
    packages=find_packages(include=["kbbq_tpu", "kbbq_tpu.*"]),
    package_data={"kbbq_tpu.io": ["native/Makefile", "native/*.cc"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy"],
    extras_require={"plot": ["matplotlib"]},
    entry_points={
        "console_scripts": ["kbbq-tpu=kbbq_tpu.cli.main:main"],
    },
)
