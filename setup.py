from setuptools import find_packages, setup

setup(
    name="nbdt-tpu",
    version="0.1.0",
    description=(
        "Neural-Backed Decision Trees, rebuilt TPU-native on JAX/XLA/Pallas"
    ),
    packages=find_packages(exclude=("tests",)),
    package_data={
        "nbdt_tpu.native": ["*.cpp"],
        "nbdt_tpu": ["hierarchies/*/*.json", "wnids/*.txt"],
        "nbdt_torch": ["csrc/*.cu", "csrc/*.cuh"],
        "nbdt_torch.native": ["*.cpp"],
    },
    include_package_data=True,
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "einops",
    ],
    extras_require={
        "full": ["nltk", "scipy", "pillow", "torch"],
        "test": ["pytest"],
    },
    entry_points={
        "console_scripts": [
            "nbdt=nbdt_tpu.bin.nbdt:main",
            "nbdt-hierarchy=nbdt_tpu.bin.nbdt_hierarchy:main",
            "nbdt-wnids=nbdt_tpu.bin.nbdt_wnids:main",
            "nbdt-original=nbdt_tpu.bin.original:main",
            "nbdt-export=nbdt_tpu.bin.nbdt_export:main",
            "nbdt-torch=nbdt_torch.bin.nbdt:main",
            "nbdt-torch-original=nbdt_torch.bin.original:main",
            "nbdt-torch-export=nbdt_torch.bin.nbdt_export:main",
        ]
    },
)
