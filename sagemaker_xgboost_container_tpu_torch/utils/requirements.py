"""Install a user module's requirements.txt before its code is imported.

SageMaker's script mode installs a customer ``requirements.txt`` before it
loads the customer's code, and fails hard on a pip error. Same here, with
one guard on top: the install runs under a pip constraints file that pins
the installed versions of the port's own runtime, so a customer pin cannot
swap torch or numpy from under the live model server. Used by the serving
loader (``serving/server._load_user_hooks``).
"""

import logging
import os
import subprocess
import sys
import tempfile

from ..toolkit import exceptions as exc

logger = logging.getLogger(__name__)

# packages the port depends on at runtime: a user requirements.txt may add
# packages freely but must not move these out from under the running server
FRAMEWORK_CRITICAL = ("torch", "numpy", "scipy", "pandas", "pyarrow")


def _write_constraints_file():
    """Pin the installed versions of ``FRAMEWORK_CRITICAL`` into a pip
    constraints file. -> its path, or None when nothing is pinnable
    (constraints apply only to packages the resolver touches, so absent
    packages need no entry)."""
    import importlib.metadata as md

    pins = []
    for pkg in FRAMEWORK_CRITICAL:
        try:
            ver = md.version(pkg)
        except md.PackageNotFoundError:
            continue
        # a PEP 440 local label ('2.5.1+cu124') names a build pip cannot
        # resolve against an index, so an exact pin would fail every user
        # install, and a pin of the public version would let pip swap the
        # CUDA build for the index wheel: that package stays unpinned
        if "+" in ver:
            logger.info(
                "Not constraining %s==%s (local build label; pip cannot "
                "resolve it against an index)", pkg, ver,
            )
            continue
        pins.append("{}=={}".format(pkg, ver))
    if not pins:
        return None
    fd, path = tempfile.mkstemp(prefix="port-constraints-", suffix=".txt")
    with os.fdopen(fd, "w") as f:
        f.write("\n".join(pins) + "\n")
    return path


def install_requirements_if_present(code_dir):
    """pip-install ``code_dir/requirements.txt`` when it exists -> whether
    it did.

    The install runs under the constraints file of ``FRAMEWORK_CRITICAL``
    (``GRAFT_PIP_NO_CONSTRAINTS=1`` turns it off). Raises UserError on a pip
    failure (bad pins, no network where the model is deployed, ...)."""
    path = os.path.join(code_dir, "requirements.txt")
    if not os.path.isfile(path):
        return False
    logger.info("Installing packages from %s...", path)
    cmd = [sys.executable, "-m", "pip", "install", "-r", path]
    cpath = None
    if os.environ.get("GRAFT_PIP_NO_CONSTRAINTS") != "1":
        cpath = _write_constraints_file()
        if cpath:
            with open(cpath) as f:
                logger.info(
                    "Constraining framework-critical packages: %s",
                    ", ".join(f.read().split()),
                )
            cmd += ["-c", cpath]
    try:
        subprocess.check_call(cmd)
    except subprocess.CalledProcessError as e:
        raise exc.UserError(
            "Failed to install packages from the user module's "
            "requirements.txt ({}). If it pins a framework-critical package "
            "({}) to an incompatible version, remove the pin or set "
            "GRAFT_PIP_NO_CONSTRAINTS=1 to override at your own risk.".format(
                path, ", ".join(FRAMEWORK_CRITICAL)
            )
        ) from e
    finally:
        if cpath:
            try:
                os.unlink(cpath)
            except OSError:
                pass
    return True
