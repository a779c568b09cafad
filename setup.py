"""Build/install horovod_tpu (parity: the reference's setup.py compiles its
native core into the wheel, setup.py:336-338; here the native coordination
core builds via its Makefile into a packaged shared library).

    pip install -e .        # or: python setup.py build

No TF/MPI/CUDA probing is needed: the data plane is jax/XLA (pure Python
deps) and the native core is dependency-free C++14 over POSIX sockets.
"""

import os
import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithNativeCore(build_py):
    def run(self):
        here = os.path.dirname(os.path.abspath(__file__))
        coord = os.path.join(here, "horovod_tpu", "coord")
        subprocess.run(["make", "-C", coord], check=True)
        super().run()


setup(
    name="horovod_tpu",
    version="0.1.0",
    description="TPU-native distributed training framework "
                "(Horovod v0.11.2 capability parity)",
    # horovod_tpu_torch: the PyTorch/CUDA port (its CUDA sources and its
    # coordinator's C++ ship as package data and are built with nvcc and
    # g++ on first use; it needs torch, which the JAX package does not).
    packages=find_packages(include=["horovod_tpu", "horovod_tpu.*",
                                    "horovod_tpu_torch",
                                    "horovod_tpu_torch.*"]),
    package_data={"horovod_tpu.coord": ["libhvdcoord.so", "coordinator.cc",
                                        "Makefile"],
                  "horovod_tpu_torch.ops": ["csrc/*.cu"],
                  "horovod_tpu_torch.coord": ["csrc/*.cc"]},
    python_requires=">=3.10",
    # jax floor: 0.9 is the version every CI leg verifies (this image
    # ships exactly one jax, so older floors would be untested claims).
    # The only cross-version API the package touches is
    # all_gather_invariant, shimmed for three jax generations in
    # utils/compat.py (README "Version matrix" states the coverage).
    install_requires=["jax>=0.9", "flax", "optax", "orbax-checkpoint",
                      "numpy"],
    # "digits" real-dataset loader (data.load_dataset) needs sklearn.
    extras_require={"datasets": ["scikit-learn"], "torch": ["torch"]},
    scripts=["bin/tpurun", "bin/tpurun_torch"],
    cmdclass={"build_py": BuildWithNativeCore},
)
