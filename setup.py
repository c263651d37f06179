"""Packaging for vstrains-tpu (parity with reference setup.py console
script: /root/reference/setup.py:17-48)."""

from setuptools import find_packages, setup

setup(
    name="vstrains-tpu",
    version="0.1.0",
    description="Device-accelerated de novo viral strain reconstruction from "
                "SPAdes assembly graphs and paired-end reads",
    packages=find_packages(include=["vstrains_tpu", "vstrains_tpu.*"]),
    package_data={"vstrains_tpu.native": ["*.cpp"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
    ],
    entry_points={
        "console_scripts": [
            "vstrains-tpu=vstrains_tpu.cli:main",
            "vstrains-tpu-pe=vstrains_tpu.pe_cli:main",
            "vstrains-tpu-prewarm=vstrains_tpu.prewarm:main",
        ],
    },
)
