"""The port's dependency-version contract, in one place.

``SUPPORTED`` holds the floor of each package the port imports at module
level (torch, numpy, scipy) and of ``packaging``, which ``violations`` needs.
Three places read it:

* ``setup.py`` turns it into the ``torch`` extra
  (``pip install .[torch]``), so pip refuses an unsupported stack;
* an image build runs ``python -m
  sagemaker_xgboost_container_tpu_torch.version_contract``, which exits
  non-zero naming every violation;
* ``tests/test_torch_packaging.py`` holds the live environment to it.

Optional packages the port imports only inside the branch that needs them
(pyarrow for parquet, psutil for the runtime gauges, sklearn for the
estimators' tags) are not part of it.

``setup.py`` loads this file by path before anything is installed, so its
module level imports the standard library only.
"""

# floors: the oldest releases the port is written against. A CUDA build's
# local version (2.11.0+cu128) and a CPU build's (2.13.0+cpu) both satisfy
# the torch floor. No upper bounds: widen deliberately, with tests.
SUPPORTED = {
    "torch": ">=2.4",
    "numpy": ">=1.24",
    "scipy": ">=1.10",
    "packaging": ">=21.0",
}


def install_requires():
    """The contract as pip requirement specifiers."""
    return [name + spec for name, spec in sorted(SUPPORTED.items())]


def violations():
    """[(package, installed version or None, required spec), ...] for every
    entry the live environment fails."""
    import importlib.metadata as md

    from packaging.specifiers import SpecifierSet
    from packaging.version import Version

    bad = []
    for name, spec in sorted(SUPPORTED.items()):
        try:
            installed = md.version(name)
        except md.PackageNotFoundError:
            bad.append((name, None, spec))
            continue
        if Version(installed) not in SpecifierSet(spec):
            bad.append((name, installed, spec))
    return bad


def assert_supported():
    """Raise RuntimeError listing every violation."""
    bad = violations()
    if bad:
        raise RuntimeError(
            "dependency contract violated: "
            + "; ".join("{} {} (need {})".format(n, v or "MISSING", s) for n, v, s in bad)
        )


if __name__ == "__main__":
    assert_supported()
    print("dependency contract OK")
