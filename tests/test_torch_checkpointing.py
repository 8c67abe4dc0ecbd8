"""Resume from checkpoints with integrity manifests, against the JAX
package's ``load_checkpoint``.

Both packages write a ``.manifest`` sidecar (sha256, byte count, iteration,
config fingerprint) beside every checkpoint and resume only from a
checkpoint whose bytes match it; a save drops the sidecar of the name it
overwrites. Saves and manifest writes retry transient errors, and the
abort path flushes the live savers.
"""

import os

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.training import checkpointing as jax_checkpointing
from sagemaker_xgboost_container_tpu.utils import integrity as jax_integrity
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest, Tree
from sagemaker_xgboost_container_tpu_torch.training import checkpointing
from sagemaker_xgboost_container_tpu_torch.utils import integrity


def _forest(leaf):
    forest = Forest(objective_name="binary:logistic", num_feature=2, device="cpu")
    forest.append_round([Tree(feature=[1, 0, 0], threshold=[0.25, 0, 0],
                              default_left=[1, 0, 0], left=[1, -1, -1], right=[2, -1, -1],
                              value=[0.0, leaf, -leaf])], [0])
    return forest


def _jax_checkpoints(ckpt, iterations):
    """Checkpoints with the JAX package's manifests, as its training writes
    them."""
    saver = jax_checkpointing.SaveCheckpointCallBack(ckpt, max_to_keep=5)
    for i in iterations:
        saver.after_iteration(_forest(0.125 + i), i, {})
    saver.stop()


def _path(ckpt, i):
    return os.path.join(ckpt, "xgboost-checkpoint.{}".format(i))


def _flip_a_digit(path):
    """Change one digit of the leaf value: the file stays valid JSON of the
    same length, only its digest tells."""
    raw = open(path, "rb").read()
    at = raw.index(b"2.125")
    with open(path, "wb") as f:
        f.write(raw[:at] + b"3" + raw[at + 1:])


@pytest.mark.parametrize("loader", ["port", "jax"])
def test_tampered_checkpoint_falls_back_to_the_one_before(loader, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _jax_checkpoints(ckpt, [1, 2])
    assert os.path.isfile(_path(ckpt, 2) + ".manifest")
    _flip_a_digit(_path(ckpt, 2))
    assert Forest.load_model(_path(ckpt, 2), device="cpu").trees[0].value[1] == 3.125
    load = checkpointing.load_checkpoint if loader == "port" else jax_checkpointing.load_checkpoint
    assert load(ckpt) == (_path(ckpt, 1), 2)


def test_port_and_jax_agree_on_every_candidate(tmp_path):
    """Without tampering both pick the newest; a truncated newest falls
    back; a manifest whose checkpoint is gone is swept."""
    ckpt = str(tmp_path / "ckpt")
    _jax_checkpoints(ckpt, [1, 2, 3])
    os.remove(_path(ckpt, 3))
    assert checkpointing.load_checkpoint(ckpt) == (_path(ckpt, 2), 3)
    assert not os.path.exists(_path(ckpt, 3) + ".manifest")
    assert jax_checkpointing.load_checkpoint(ckpt) == (_path(ckpt, 2), 3)
    with open(_path(ckpt, 2), "r+b") as f:
        f.truncate(10)
    assert checkpointing.load_checkpoint(ckpt) == jax_checkpointing.load_checkpoint(ckpt) == (
        _path(ckpt, 1), 2)


def test_overwriting_a_checkpoint_drops_its_stale_manifest(tmp_path):
    """The port re-saves an iteration the JAX package checkpointed (a resume
    re-writes it): the JAX sidecar describes the old bytes and must go, or
    the repaired reader would reject the good new checkpoint."""
    ckpt = str(tmp_path / "ckpt")
    _jax_checkpoints(ckpt, [1, 2])
    stale = open(_path(ckpt, 2) + ".manifest").read()
    saver = checkpointing.SaveCheckpointCallBack(ckpt, max_to_keep=5)
    saver.after_iteration(_forest(7.5), 2, {})
    saver.stop()
    # the stale sidecar is gone; the port's own describes the new bytes
    assert open(_path(ckpt, 2) + ".manifest").read() != stale
    for check in (integrity.check_model_file, jax_integrity.check_model_file):
        assert check(_path(ckpt, 2)) == "verified"
    assert os.path.exists(_path(ckpt, 1) + ".manifest")
    for load in (checkpointing.load_checkpoint, jax_checkpointing.load_checkpoint):
        assert load(ckpt) == (_path(ckpt, 2), 3)
    resumed = Forest.load_model(checkpointing.load_checkpoint(ckpt)[0], device="cpu")
    np.testing.assert_array_equal(resumed.trees[0].value, [0.0, 7.5, -7.5])


def test_intermediate_model_overwrite_drops_its_stale_manifest(tmp_path):
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    (model_dir / "xgboost-model.manifest").write_text('{"sha256": "0", "bytes": 1}')
    cb = checkpointing.SaveIntermediateModelCallBack(str(model_dir), "xgboost-model", True)
    cb.after_iteration(_forest(1.0), 0, {})
    assert sorted(os.listdir(model_dir)) == ["xgboost-model"]


# ------------------------------------------------- manifests, retries, flush
def test_port_checkpoints_carry_manifests_the_jax_package_reads(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    fingerprint = integrity.config_fingerprint({"objective": "binary:logistic", "max_depth": 3})
    saver = checkpointing.SaveCheckpointCallBack(ckpt, max_to_keep=5, fingerprint=fingerprint)
    for i in range(3):
        saver.after_iteration(_forest(0.5 + i), i, {})
    saver.stop()
    for i in range(3):
        manifest = jax_integrity.read_manifest(_path(ckpt, i))
        assert manifest["iteration"] == i and manifest["fingerprint"] == fingerprint
        assert jax_integrity.check_model_file(_path(ckpt, i)) == "verified"
        assert manifest == integrity.build_manifest(_path(ckpt, i), iteration=i,
                                                    fingerprint=fingerprint)
    assert jax_checkpointing.load_checkpoint(ckpt) == checkpointing.load_checkpoint(ckpt) == (
        _path(ckpt, 2), 3)


def test_retention_removes_each_sidecar_with_its_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    saver = checkpointing.SaveCheckpointCallBack(ckpt, max_to_keep=2)
    for i in range(5):
        saver.after_iteration(_forest(1.0), i, {})
    saver.stop()
    assert sorted(os.listdir(ckpt)) == sorted(
        "xgboost-checkpoint.{}{}".format(i, s) for i in (3, 4) for s in ("", ".manifest"))


@pytest.mark.parametrize("spec", ["checkpoint.save:error:EBS blip@1",
                                  "checkpoint.manifest:error:EBS blip@1"])
def test_transient_save_errors_retry_and_leave_no_debris(tmp_path, spec):
    from sagemaker_xgboost_container_tpu_torch.utils import faults

    faults.configure(spec)
    try:
        checkpointing._atomic_save(_forest(2.0), str(tmp_path), "xgboost-checkpoint.0",
                                   iteration=0)
        assert sum(faults.fault_counts().values()) == 1
    finally:
        faults.reset()
    assert sorted(os.listdir(tmp_path)) == ["xgboost-checkpoint.0",
                                            "xgboost-checkpoint.0.manifest"]
    assert integrity.check_model_file(str(tmp_path / "xgboost-checkpoint.0")) == "verified"


def test_live_savers_are_flushed_and_forgotten(tmp_path):
    import gc

    saver = checkpointing.SaveCheckpointCallBack(str(tmp_path / "a"))
    assert str(tmp_path / "a") in checkpointing.active_checkpoint_dirs()
    saver.after_iteration(_forest(1.0), 0, {})
    checkpointing.flush_checkpoints(timeout=5.0)
    assert not saver.thread.is_alive()
    del saver
    gc.collect()
    assert str(tmp_path / "a") not in checkpointing.active_checkpoint_dirs()
