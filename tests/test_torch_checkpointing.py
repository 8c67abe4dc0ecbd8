"""Resume from checkpoints with integrity manifests, against the JAX
package's ``load_checkpoint``.

The JAX package writes a ``.manifest`` sidecar (sha256 + byte count) beside
every checkpoint and resumes only from a checkpoint whose bytes match it.
The port writes none, verifies them on load, and drops a sidecar of any
checkpoint name it overwrites.
"""

import os

import numpy as np
import pytest

from sagemaker_xgboost_container_tpu.training import checkpointing as jax_checkpointing
from sagemaker_xgboost_container_tpu_torch.models.forest import Forest, Tree
from sagemaker_xgboost_container_tpu_torch.training import checkpointing


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
    saver = checkpointing.SaveCheckpointCallBack(ckpt, max_to_keep=5)
    saver.after_iteration(_forest(7.5), 2, {})
    saver.stop()
    assert not os.path.exists(_path(ckpt, 2) + ".manifest")
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
