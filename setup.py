"""Packaging for custrings (reference: python/setup.py ships prebuilt
shims; here the only native piece builds itself at import via the system
compiler — see custrings/native/build.py)."""

from setuptools import find_packages, setup

setup(
    name="custrings",
    version="0.1.0",
    description="Columnar string engine in JAX (cuStrings capabilities)",
    packages=find_packages(exclude=("tests",)),
    package_data={"custrings.native": ["*.c"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
)
