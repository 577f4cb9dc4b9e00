from setuptools import setup, find_packages

setup(
    name="pyneuralempc_tpu",
    version="0.1.0",
    description=("TPU-native economic MPC: neural-network dynamics, "
                 "autodiff NLP transcription, batched interior-point solves "
                 "compiled to XLA"),
    packages=find_packages(exclude=("tests",)),
    # the PyTorch port builds its CUDA kernels from these sources at first use
    package_data={"pyneuralempc_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    extras_require={"test": ["pytest", "scipy", "optax"],
                    "torch": ["torch"]},
)
