import os
import runpy

from setuptools import Extension, find_packages, setup


def read(fname):
    with open(os.path.join(os.path.dirname(__file__), fname)) as f:
        return f.read()


# version contract loaded by path: the package itself (and its deps) may not
# be importable yet at setup time
_contract = runpy.run_path(
    os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "sagemaker_xgboost_container_tpu",
        "version_contract.py",
    )
)


# The native data plane (libsvm tokenizer) ships as a compiled artifact in
# the wheel so installed images get the C++ parser, not the silent Python
# fallback (the reference likewise builds its ingestion natively — MLIO /
# libxgboost parsers, SURVEY.md §2.2). It is a plain C-ABI library loaded
# via ctypes, built through the Extension machinery purely for packaging;
# optional=True keeps pip install working on compiler-less hosts (the
# runtime then lazily compiles from source or falls back to Python).
fastdata_ext = Extension(
    "sagemaker_xgboost_container_tpu._fastdata",
    sources=["native/fastdata.cpp"],
    extra_compile_args=["-O3", "-pthread"],
    extra_link_args=["-pthread"],
    optional=True,
)

# the PyTorch port's own copy of the same library (its loader,
# sagemaker_xgboost_container_tpu_torch/data/native.py, reads only this one)
torch_fastdata_ext = Extension(
    "sagemaker_xgboost_container_tpu_torch._fastdata",
    sources=["native/fastdata.cpp"],
    extra_compile_args=["-O3", "-pthread"],
    extra_link_args=["-pthread"],
    optional=True,
)

# the port's dependency contract, loaded by path as the JAX package's is:
# installed with `pip install .[torch]`
_torch_contract = runpy.run_path(
    os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "sagemaker_xgboost_container_tpu_torch",
        "version_contract.py",
    )
)


setup(
    name="sagemaker_xgboost_container_tpu",
    version="0.1.0",
    description=(
        "TPU-native gradient-boosting training and serving container with the "
        "capabilities of the SageMaker XGBoost container"
    ),
    long_description=read("README.md"),
    long_description_content_type="text/markdown",
    packages=find_packages(exclude=("tests",)),
    package_data={
        "sagemaker_xgboost_container_tpu.data": ["record_pb2.py"],
        # CUDA sources of the PyTorch port, built at first use (_build.py)
        "sagemaker_xgboost_container_tpu_torch": ["csrc/*.cu", "csrc/*.h"],
    },
    ext_modules=[fastdata_ext, torch_fastdata_ext],
    python_requires=">=3.10",
    install_requires=_contract["install_requires"](),
    extras_require={"torch": _torch_contract["install_requires"]()},
    entry_points={
        "console_scripts": [
            # the container CMDs (reference setup.py:34-38)
            "train=sagemaker_xgboost_container_tpu.training.entry:main",
            "serve=sagemaker_xgboost_container_tpu.serving.server:main",
            # the PyTorch port's
            "train-torch=sagemaker_xgboost_container_tpu_torch.training.entry:main",
            "serve-torch=sagemaker_xgboost_container_tpu_torch.serving.server:main",
        ]
    },
    classifiers=[
        "Programming Language :: Python :: 3",
        "License :: OSI Approved :: Apache Software License",
    ],
)
