"""Algorithm-mode training orchestration: ``sagemaker_train`` + ``train_job``.

The port's counterpart of ``sagemaker_xgboost_container_tpu/training/algorithm_train.py``
for one host: validate hyperparameters and channels, load and check the
data matrices, run boosting with the callback stack (metric lines,
checkpoints, intermediate model, early stopping) on one device, or repeated
k-fold cross-validation (``_kfold``, ``_num_cv_round``) with out-of-fold
predictions, and save the model(s) under ``xgboost-model`` (one a fold,
``xgboost-model-{fold}``, for CV). Errors matching the known customer
substrings re-raise as UserError. The validated hyperparameters, among them
``num_class``, the objective parameters (``tweedie_variance_power``,
``huber_slope``, ``aft_loss_distribution``, ...) and the sampling ones
(``subsample``, ``colsample_*``, ``num_parallel_tree``), go to
``booster.train`` as they are; custom metrics (``accuracy``, ``f1``, ...)
become a feval; without ``eval_metric`` the objective's default metric
makes the metric lines the tuner reads.

Every objective trains, the ranking ones with the query groups of the
channel (libsvm ``qid:`` tokens or ``.group`` sidecar files; a csv channel,
or one without groups, is one group of all its rows), with depthwise or
lossguide growth; ranking metric lines read ``validation-ndcg@10`` and so
on. ``booster=dart`` / ``gblinear`` and ``process_type=update`` (over the
checkpoint's model) train through the same call, and their models are
saved and checkpointed through their ``save_model``. CV trains its folds
side by side in one tree build where ``models/cv_parallel`` allows
(``GRAFT_PARALLEL_CV``, gbtree only, as in the JAX package), else one after
another. ``monotone_constraints`` and ``interaction_constraints`` (the
strings ``"(1,0,-1)"`` and ``"[[0,1],[2,3]]"`` of hyperparameters.json,
parsed by their validators) and ``tree_method`` exact and approx train as
``booster.TrainConfig`` reads them.

More than one host (``SM_HOSTS``) trains data-parallel, the JAX package's
multi-host branch: the hosts exchange "do I have data?" over the
rendezvous channel (``parallel/distributed.distributed_run``; hosts
without data exit 0), and each participant brings up, in order, the
``torch.distributed`` process group (hosts x L ranks), the
elastic membership (``SM_ELASTIC``), the abort listener
(``SM_ABORT_ON_STALE`` or ``SM_ELASTIC``), the heartbeat plane
(``SM_HEARTBEAT_INTERVAL_S``), the consensus membership
(``SM_CONSENSUS_EVERY``), its tracing rank and the fleet plane
(``SM_FLEET_TRACE``, ``SM_STATUS_PORT``); then every rank trains on its own
channel's rows with ``booster.train(..., group=)`` and the master (sorted
hosts[0]) saves the model. With ``SM_ELASTIC`` the single-model branch
runs under ``elastic.supervised_train``: after a shrink the survivors
re-form the process group, agree one resume point (rank 0's last verified
checkpoint, sent to every survivor over the new group, since only the
master writes checkpoints) and train the remaining rounds over the new
group, the cuts merged again over the survivors' rows. k-fold CV across
hosts runs the sequential fold loop, as the JAX package does there: each
host splits its own rows, every fold trains with ``train(group=)``, the CV
metric lines are the same on every host, and each host writes the
out-of-fold predictions of its own rows; a dead host takes the coordinated
abort there. Refused across hosts with the JAX package's ``UserError``:
``tree_method=exact`` (``booster.refuse_across_ranks``).

Every local GPU trains, the JAX package's ``_training_mesh`` over a host's
devices as one process a GPU (``parallel/local.py``): L local ranks a host
(``SM_LOCAL_RANKS``, else the visible GPUs capped by the host's share of
``_num_devices``). The leader (the
process the platform started) reads the channels once into shared memory
(``local.HostMatrix``), joins the rendezvous (the hosts agree on the least
L), spawns local ranks 1..L-1 (``training.entry.local_rank_main`` ->
``run_local_rank``) and trains as local rank 0; every rank deals itself its
shard in ``train_job`` (k-fold CV: of each fold's rows, split alike on every
rank of a host) and bins with the host's cuts. Only the leader prints metric
lines, runs the planes and writes the out-of-fold predictions, and only
global rank 0 saves; a dead worker ends the host with exit 80. With
``SM_ELASTIC`` the workers register the membership in relay mode and take
their leader's verdicts over a control pipe: after a shrink every rank of
every surviving host re-forms the group (the same L, at its host's new
index), the cuts are merged again over the surviving hosts, and a dead
worker is its host's death (its leader exits 80 alone and rank 0 shrinks
the host away; on rank 0's host it is a dead master: exit 80 everywhere).

Channel ingest (``_streaming_plan``, the JAX package's): ``SM_INGEST_MODE``
``auto`` (default) streams the channels chunk by chunk into pre-binned
matrices (``data/streaming.py``) on one host whose training channel is
larger than one chunk and whose config trains from bins; ``chunked``
forces that path on any number of hosts and refuses a config it cannot
serve; ``whole`` keeps the whole-file readers. A failure of the chunked
plane exits 85 (``EXIT_INGEST_FAILED``) with a flight-recorder dump, and
the chunks a job skipped (``SM_INGEST_BAD_CHUNK_ACTION=skip``) are written
to ``ingest-quarantine.json`` and stamped into the model's manifest.
"""

import logging
import os
import shutil
import tempfile

import numpy as np

from .._device import resolve_device
from ..algorithm import channels as cv
from ..algorithm import hyperparameters as hpv
from ..algorithm import metrics as metrics_mod
from ..constants import CUSTOMER_ERRORS, MODEL_NAME, PIPE_MODE, SM_OUTPUT_DATA_DIR
from ..data.content_types import get_content_type
from ..data.readers import (
    check_data_redundancy,
    get_data_matrix,
    get_size,
    validate_data_file_path,
)
from ..models import booster
from ..models.forest import Forest
from ..parallel import distributed, local
from ..telemetry import register_runtime_gauges, span, start_cluster_telemetry
from ..toolkit import exceptions as exc
from . import train_utils
from .callbacks import get_callbacks
from .profiling import xla_trace
from .folds import RepeatedKFold, RepeatedStratifiedKFold
from .prediction_utils import ValidationPredictionRecorder

logger = logging.getLogger(__name__)


def _streaming_plan(train_cfg, train_size, combine_train_val, is_pipe, num_hosts):
    """Whole-file or chunked ingest -> (use_streaming, max_bin, cfg).

    ``SM_INGEST_MODE=chunked`` forces the chunked path and raises on a
    config it cannot serve rather than falling back; ``whole`` keeps the
    whole-file readers; ``auto`` streams a supported one-host job whose
    local training channel is larger than one chunk. Across hosts ``auto``
    stays whole-file: the choice must be the same on every rank before any
    rendezvous exists, and local channel sizes (``ShardedByS3Key``) are not;
    a forced ``chunked`` is the same everywhere by construction.
    """
    from ..data import streaming

    cfg = streaming.resolve_ingest_config()
    if train_cfg is None or is_pipe:
        if cfg.mode == "chunked":
            raise exc.UserError(
                "SM_INGEST_MODE=chunked is not supported for {}; use "
                "SM_INGEST_MODE=whole.".format(
                    "Pipe-mode input" if is_pipe
                    else "jobs without a validated training config"))
        return False, None, cfg
    if cfg.mode == "whole":
        return False, None, cfg
    ok, why, max_bin = streaming.supports_streaming(train_cfg)
    if combine_train_val and ok:
        ok, why = False, "k-fold CV slices float features per fold"
    if cfg.mode == "chunked":
        if not ok:
            raise exc.UserError(
                "SM_INGEST_MODE=chunked is not supported for this job ({}); use "
                "SM_INGEST_MODE=whole or adjust the config.".format(why))
        return True, max_bin, cfg
    if not ok or num_hosts > 1:
        return False, None, cfg
    return train_size > cfg.chunk_bytes, max_bin, cfg


def get_validated_data_matrices(
    train_path, validate_path, content_type, csv_weights=0, is_pipe=False,
    combine_train_val=False, train_cfg=None, sm_hosts=None, sm_current_host=None,
    device=None,
):
    """Size/format-check both channels and parse them into DataMatrix objects.

    Where ``_streaming_plan`` arms the streaming plane, the channels are
    ingested chunk by chunk into pre-binned matrices instead
    (``data/streaming.py``, binned on ``device``): the training channel
    makes the cuts (agreed across ``sm_hosts``), the validation channel is
    binned with them. The chunked plane's failures raise
    ``streaming.IngestError``; the caller turns them into exit 85.
    """
    train_size = get_size(train_path, is_pipe) if train_path else 0
    val_size = get_size(validate_path, is_pipe) if validate_path else 0

    if not is_pipe:
        if train_size > 0:
            validate_data_file_path(train_path, content_type)
        if val_size > 0:
            validate_data_file_path(validate_path, content_type)

    num_hosts = len(sm_hosts) if sm_hosts else 1
    use_streaming, max_bin, cfg = _streaming_plan(
        train_cfg, train_size, combine_train_val, is_pipe, num_hosts)
    if use_streaming:
        from ..data import streaming

        if streaming.channel_has_sidecars(content_type, train_path, validate_path):
            if cfg.mode == "chunked":
                raise exc.UserError(
                    "SM_INGEST_MODE=chunked cannot honor libsvm .weight/.group sidecar "
                    "files; remove them or use SM_INGEST_MODE=whole.")
            logger.info("channel carries libsvm .weight/.group sidecar files; using the "
                        "whole-file readers (chunked ingest cannot honor them)")
            use_streaming = False
    if use_streaming:
        hosts = sm_hosts if num_hosts > 1 else None
        # the job's quarantine record and skip budget start empty: a second
        # job in this process must not inherit the last one's
        streaming.reset_ingest_state()
        logger.info("Streaming (chunked) channel ingest armed: max_bin=%d, %d host(s)",
                    max_bin, num_hosts)
        # every host joins the exchange whatever its channel holds (a host
        # without data sends an empty sketch and gets None): its peers must
        # never wait for its summary
        train_dmatrix = streaming.ingest_channel(
            train_path, content_type, max_bin, channel="train", csv_weights=csv_weights,
            hosts=hosts, current_host=sm_current_host, device=device)
        val_dmatrix = None
        if validate_path is not None and (val_size > 0 or num_hosts > 1):
            val_dmatrix = streaming.ingest_channel(
                validate_path, content_type, max_bin, channel="validation",
                csv_weights=csv_weights,
                cut_points=train_dmatrix.cut_points if train_dmatrix else None,
                hosts=hosts, current_host=sm_current_host, device=device)
            if train_dmatrix is None:
                # a host without training rows joined the validation
                # exchange, but its validation rows were sketched against
                # themselves: they must not reach an eval; the host leaves
                # through the no-data path
                val_dmatrix = None
        return train_dmatrix, val_dmatrix, train_dmatrix

    train_dmatrix = (
        get_data_matrix(train_path, content_type, csv_weights=csv_weights, is_pipe=is_pipe)
        if train_size > 0
        else None
    )
    val_dmatrix = (
        get_data_matrix(validate_path, content_type, csv_weights=csv_weights, is_pipe=is_pipe)
        if val_size > 0
        else None
    )

    train_val_dmatrix = train_dmatrix
    if combine_train_val and train_dmatrix is not None and val_dmatrix is not None:
        logger.info("Read both train and validation data into one DataMatrix")
        train_val_dmatrix = train_dmatrix.concat(val_dmatrix)
    return train_dmatrix, val_dmatrix, train_val_dmatrix


def sagemaker_train(
    train_config,
    data_config,
    train_path,
    val_path,
    model_dir,
    sm_hosts,
    sm_current_host,
    checkpoint_config,
    device=None,
):
    """Validate config, load data, run train_job on ``device`` (CUDA unless
    given; raises without a GPU unless ``device="cpu"``, once the
    hyperparameters and channels have been validated)."""
    # RSS / fds / threads / device-bytes gauges, before any kernel work
    register_runtime_gauges()
    metrics = metrics_mod.initialize()
    hyperparameters = hpv.initialize(metrics)
    validated_train_config = hyperparameters.validate(train_config)
    if validated_train_config.get("updater"):
        validated_train_config["updater"] = ",".join(validated_train_config["updater"])

    channels = cv.initialize()
    validated_data_config = channels.validate(data_config)

    file_type = get_content_type(validated_data_config["train"].get("ContentType"))
    input_mode = validated_data_config["train"].get("TrainingInputMode")
    csv_weights = validated_train_config.get("csv_weights", 0)
    is_pipe = input_mode == PIPE_MODE

    validation_channel = validated_data_config.get("validation", None)
    combine_train_val = "_kfold" in validated_train_config
    num_hosts = len(sm_hosts)
    if num_hosts > 1:
        _refuse_across_hosts(validated_train_config)
    if val_path is not None:
        if train_path == val_path or os.path.basename(train_path) == os.path.basename(val_path):
            logger.warning(
                "Found same path for training and validation. This is not recommended "
                "and results may not be correct."
            )
        elif not is_pipe:
            check_data_redundancy(train_path, val_path)

    checkpoint_dir = checkpoint_config.get("LocalPath", None)

    if validated_train_config.pop("use_dask_gpu_training", "false") == "true":
        raise exc.UserError(
            "use_dask_gpu_training is not supported by the PyTorch port: it trains one "
            "process on every local GPU without Dask; remove this hyperparameter."
        )

    dev = resolve_device(device)
    local_size = _local_ranks(num_hosts, validated_train_config.pop("_num_devices", None), dev)
    with span("data_ingest", emit=True):
        from ..data import streaming

        try:
            train_dmatrix, val_dmatrix, train_val_dmatrix = get_validated_data_matrices(
                train_path, val_path, file_type, csv_weights, is_pipe, combine_train_val,
                train_cfg=validated_train_config, sm_hosts=sm_hosts,
                sm_current_host=sm_current_host, device=dev,
            )
        except streaming.IngestError as e:
            # the chunked plane's failure contract: every rank reached this
            # verdict from the same allgathered state; flight-recorder dump
            # and EXIT_INGEST_FAILED (85) on each
            streaming.abort_on_ingest_failure(e)
            # reached only where the exit is faked (tests): the failure file
            # names the ingest error
            raise exc.PlatformError(str(e))
    missing_validation_data = validation_channel and not val_dmatrix
    if num_hosts == 1 and local_size > 1:
        # the one-host checks of the single-rank branch, before any spawn
        if not train_dmatrix:
            raise exc.UserError("No data in training channel path {}".format(train_path))
        if missing_validation_data:
            raise exc.UserError("No data in validation channel path {}".format(val_path))

    train_args = dict(
        train_cfg=validated_train_config,
        train_dmatrix=train_dmatrix,
        val_dmatrix=val_dmatrix,
        train_val_dmatrix=train_val_dmatrix,
        model_dir=model_dir,
        checkpoint_dir=checkpoint_dir,
        device=dev,
    )
    from ..telemetry import fleet

    host_matrices = {}
    if local_size > 1 and train_dmatrix:
        # the host's channels in shared memory, once: every local rank
        # trains on its shard of them, and the leader drops its own copy
        host_matrices = _publish_host_matrices(train_args)
        train_dmatrix, val_dmatrix, train_val_dmatrix = (train_args[k] for k in _MATRIX_KEYS)

    if num_hosts > 1 or local_size > 1:
        logger.info("Distributed node training with %d hosts: %s (%d local rank(s) a host)",
                    num_hosts, sm_hosts, local_size)
        if num_hosts > 1:
            distributed.wait_hostname_resolution(sm_hosts)
        include_in_training = True
        if not train_dmatrix:
            logger.warning(
                "Host %s does not have training data and will not be used in "
                "distributed training. Please divide the training data across "
                "instances properly.", sm_current_host)
            include_in_training = False
        if missing_validation_data:
            logger.warning(
                "Host %s does not have validation data in the validation channel and "
                "will not be used in distributed training.", sm_current_host)
            include_in_training = False

        def _pre_exec(participating_hosts, current_host, local_ranks=1):
            # the JAX package's order: the process group first, then the
            # elastic membership (its SM_ELASTIC snapshot gates the abort
            # listener), the abort listener (up before rank 0's aggregator
            # can ever decide to broadcast), the heartbeat plane over the
            # participating hosts (hosts without data already left), the
            # consensus membership, the tracing rank, and the fleet plane
            # last (span shipping needs the rank). With local ranks the
            # workers start first (each joins the group itself) and the
            # planes stay one a host, in this leader
            from ..telemetry import tracing
            from . import consensus, elastic
            from .watchdog import start_abort_plane

            ordered = sorted(participating_hosts)
            topo = local.Topology(len(ordered), ordered.index(current_host), local_ranks, 0)
            # the elastic knobs, resolved once: this leader and its workers
            # register the same snapshot. k-fold CV trains a callback stack a
            # fold, with no single resume point to re-form around: the plane
            # stays unregistered and a dead host takes the coordinated abort
            elastic_cfg = None if combine_train_val else elastic.resolve_elastic_config()
            rank_dev = dev
            if topo.local_size > 1:
                rank_dev = local.rank_device(dev, 0)
                train_args["device"] = rank_dev
                _spawn_workers(topo, participating_hosts, current_host, dev, train_args,
                               host_matrices, checkpoint_dir, elastic_cfg)
                fleet.note_status(local_ranks=topo.local_size, local_devices=[
                    str(local.rank_device(dev, r)) for r in range(topo.local_size)])
            distributed.init_process_group(participating_hosts, current_host, rank_dev,
                                           rank=topo.global_rank, world_size=topo.world_size)
            if elastic_cfg is None:
                if elastic.resolve_elastic_config().enabled:
                    logger.warning("SM_ELASTIC is not supported for k-fold CV jobs; a dead "
                                   "host takes the coordinated abort")
            else:
                elastic.register_cluster(participating_hosts, current_host, config=elastic_cfg)
            start_abort_plane(participating_hosts, current_host)
            start_cluster_telemetry(participating_hosts, current_host)
            consensus.register_cluster(participating_hosts, current_host)
            tracing.set_rank(sorted(participating_hosts).index(current_host))
            fleet.start_fleet_plane(participating_hosts, current_host)

        finished = False

        def _train_job(**kwargs):
            bst = train_job(**kwargs)
            # the workers' collectives are over: from here a worker's exit
            # (its teardown) is no longer this host's failure
            local.quiet_local_ranks()
            return bst

        try:
            distributed.distributed_run(
                exec_fun=_train_job,
                args=train_args,
                include_in_training=include_in_training,
                hosts=sm_hosts,
                current_host=sm_current_host,
                port=distributed.rendezvous_port(),
                pre_exec=_pre_exec,
                local_ranks=local_size,
            )
            finished = True
        finally:
            _stop_cluster_planes()
            fleet.stop_fleet_plane()
            # the workers first: this process may hold the group's store
            for _rank, message in local.stop_local_ranks(graceful=finished):
                logger.warning("after training: %s", message)
            distributed.destroy_process_group()
            local.set_topology(None)
            for m in host_matrices.values():
                m.close()
    elif num_hosts == 1:
        if train_dmatrix:
            if missing_validation_data:
                raise exc.UserError("No data in validation channel path {}".format(val_path))
            logger.info("Single node training.")
            # one host still gets the /status endpoint (and, with
            # SM_FLEET_TRACE, a one-lane merged trace over loopback)
            fleet.start_fleet_plane([sm_current_host], sm_current_host)
            try:
                train_job(is_master=True, **train_args)
            finally:
                fleet.stop_fleet_plane()
        else:
            raise exc.UserError("No data in training channel path {}".format(train_path))
    else:
        raise exc.PlatformError("Number of hosts should be an int greater than or equal to 1")


def _local_ranks(num_hosts, num_devices_cap, device):
    """L, this host's training ranks (``parallel/local.local_world_size``),
    resolved once at start: an elastic reform keeps it (the JAX package
    re-applies its ``_num_devices`` cap over the survivors' devices; the
    port spawns no worker at a reform)."""
    return local.local_world_size(num_hosts, num_devices_cap, device)


_MATRIX_KEYS = ("train_dmatrix", "val_dmatrix", "train_val_dmatrix")


def _publish_host_matrices(train_args):
    """Place each distinct matrix of ``train_args`` in shared memory and
    point ``train_args`` at the shared copy -> {key: HostMatrix}."""
    published, out = {}, {}
    for key in _MATRIX_KEYS:
        dm = train_args.get(key)
        if dm is None:
            continue
        if id(dm) not in published:
            published[id(dm)] = local.HostMatrix.publish(dm)
        out[key] = published[id(dm)]
        train_args[key] = out[key].matrix
    return out


def _spawn_workers(topo, hosts, current_host, device, train_args, host_matrices,
                   checkpoint_dir, elastic_cfg=None):
    """Start local ranks 1..L-1 of ``topo`` over the shared matrices
    (``training.entry.local_rank_main``); with ``elastic_cfg`` (the
    leader's ``ElasticConfig``) they register the membership in relay
    mode."""
    from . import entry
    from .watchdog import on_local_rank_failure

    unique = []
    for m in host_matrices.values():
        if m not in unique:
            unique.append(m)
    spec = {
        "hosts": list(hosts), "current_host": current_host,
        "num_hosts": topo.num_hosts, "host_index": topo.host_index,
        "local_size": topo.local_size, "device": str(device),
        "train_cfg": dict(train_args["train_cfg"]),
        # each distinct shared matrix once, and the keys that name it
        "matrices": [m.descriptor for m in unique],
        "matrix_keys": {k: unique.index(m) for k, m in host_matrices.items()},
        "model_dir": train_args["model_dir"], "checkpoint_dir": checkpoint_dir,
        "elastic": elastic_cfg,
    }
    local.spawn_local_ranks(topo, spec, entry.local_rank_main, on_local_rank_failure)
    local.set_topology(topo)
    local.share_host_threads(topo.local_size)


def run_local_rank(local_rank, spec):
    """The body of a spawned local rank: listen to its leader's verdicts,
    attach the host's shared matrices, join the process group as global
    rank host index x L + local rank, register the elastic membership in
    relay mode where the leader registered it, and train this rank's shard
    (``train_job`` with ``is_master=False``: it prints no metric lines and
    saves nothing)."""
    import torch

    from . import elastic
    from .watchdog import on_leader_verdict

    if spec.get("control") is not None:
        local.listen_to_leader(spec["control"], on_leader_verdict)
    topo = local.Topology(spec["num_hosts"], spec["host_index"], spec["local_size"],
                          local_rank)
    local.set_topology(topo)
    local.share_host_threads(topo.local_size)
    attached = [local.HostMatrix.attach(desc) for desc in spec["matrices"]]
    mats = {key: attached[i].matrix for key, i in spec["matrix_keys"].items()}
    dev = local.rank_device(torch.device(spec["device"]), local_rank)
    try:
        distributed.init_process_group(spec["hosts"], spec["current_host"], dev,
                                       rank=topo.global_rank, world_size=topo.world_size)
        if spec.get("elastic") is not None:
            elastic.register_cluster(spec["hosts"], spec["current_host"],
                                     config=spec["elastic"], relay=True)
        train_job(spec["train_cfg"], mats.get("train_dmatrix"), mats.get("val_dmatrix"),
                  mats.get("train_val_dmatrix"), spec["model_dir"], spec["checkpoint_dir"],
                  is_master=False, device=dev)
    finally:
        try:
            distributed.destroy_process_group()
        except Exception as e:  # a peer's teardown got there first
            logger.warning("process group teardown: %s", e)
        mats.clear()
        for m in attached:
            m.close()


def _refuse_across_hosts(train_cfg):
    """Raise the JAX package's ``UserError`` for what does not train
    across hosts (``tree_method=exact``), before any data is read."""
    booster.refuse_across_ranks(booster.TrainConfig(dict(train_cfg)))


def _training_group():
    """The process group of a multi-host job (the JAX package's
    ``_training_mesh``): the default group when one is up with more than
    one rank, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def _stop_cluster_planes():
    """Stop the heartbeat and abort planes. After the last round's
    collective no peer is needed any more: a peer that finished first and
    exited must not be declared stale while this host saves."""
    from ..telemetry.cluster import stop_cluster_telemetry
    from .watchdog import stop_abort_plane

    stop_cluster_telemetry()
    stop_abort_plane()


def _agree_resume_point(checkpoint_dir, device, tmp_dir):
    """After a shrink: every survivor resumes where rank 0 does -> (model
    path or None, iteration).

    Only the master writes checkpoints, so a survivor re-reading its own
    directory would restart at round 0 while rank 0 resumes at round k, and
    their collectives would be out of step at once. Rank 0 reads its last
    verified checkpoint (``load_checkpoint``; none: round 0) and broadcasts
    the iteration and the file's bytes over the new group; every other rank
    writes the bytes under ``tmp_dir`` and resumes from that file.
    """
    import torch
    import torch.distributed as dist

    from . import checkpointing

    group = _training_group()
    rank = dist.get_rank() if group is not None else 0
    path, iteration, data = None, 0, b""
    if rank == 0:
        path, iteration = checkpointing.load_checkpoint(checkpoint_dir)
        if path is not None:
            with open(path, "rb") as f:
                data = f.read()
    if group is None:
        return path, iteration
    head = torch.tensor([iteration, len(data)], dtype=torch.int64, device=device)
    dist.broadcast(head, src=0, group=group)
    iteration, nbytes = (int(v) for v in head.cpu().tolist())
    if nbytes:
        if rank == 0:
            buf = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device)
        else:
            buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
        dist.broadcast(buf, src=0, group=group)
        if rank != 0:
            path = os.path.join(tmp_dir, "{}.{}".format(checkpointing.CHECKPOINT_FILENAME,
                                                        iteration - 1))
            with open(path, "wb") as f:
                f.write(buf.cpu().numpy().tobytes())
    logger.info("elastic: every survivor resumes at iteration %d (%s)", iteration,
                "rank 0's checkpoint" if nbytes else "no checkpoint: round 0")
    return path, iteration


def train_job(
    train_cfg, train_dmatrix, val_dmatrix, train_val_dmatrix, model_dir, checkpoint_dir,
    is_master, device=None,
):
    """Run boosting (or repeated k-fold CV) on this node on ``device``; save
    the model(s) (master only).

    With the elastic plane armed (``SM_ELASTIC``) the single-model branch
    runs under ``elastic.supervised_train``: a shrink unwinds the boosting
    loop, the survivors re-rendezvous, ``_on_reform`` re-forms the process
    group and the planes over them and agrees the resume point, and
    ``_train_once`` rebuilds the callbacks and the session over the new
    group. ``is_master`` survives a shrink: the master is the sorted-first
    host, and only its aggregator proposes a shrink (a dead master is not
    survivable: the survivors exit 80)."""
    train_cfg = dict(train_cfg)
    num_round = train_cfg.pop("num_round")
    save_model_on_termination = train_cfg.pop("save_model_on_termination", "false")
    # no reference to the group is held here: an elastic reform can only
    # close the old group's connections once nothing references it
    multi_rank = _training_group() is not None
    # planned rounds feed the /status ETA, and kill -3 becomes a live
    # inspection dump instead of the default core-dump abort
    from ..telemetry import fleet

    fleet.note_status(rounds_planned=num_round)
    fleet.install_sigquit_handler(default_dir=model_dir)

    tuning_objective_metric_param = train_cfg.pop("_tuning_objective_metric", None)
    eval_metric = train_cfg.get("eval_metric")
    cleaned_eval_metric, configured_feval, tuning_objective_metric = (
        train_utils.get_eval_metrics_and_feval(tuning_objective_metric_param, eval_metric)
    )
    if cleaned_eval_metric:
        train_cfg["eval_metric"] = cleaned_eval_metric
    else:
        train_cfg.pop("eval_metric", None)

    early_stopping_rounds = train_cfg.pop("early_stopping_rounds", None)
    early_stopping_data_name = "validation" if val_dmatrix else None
    early_stopping_metric = None
    if early_stopping_rounds:
        if tuning_objective_metric:
            early_stopping_metric = tuning_objective_metric[-1]
        elif eval_metric:
            early_stopping_metric = eval_metric[-1]

    topo = local.topology()
    if topo is not None and "_kfold" not in train_cfg:
        # this local rank's shard of the host's rows (k-fold CV deals each
        # fold's rows instead)
        train_dmatrix = local.shard_matrix(train_dmatrix, topo)
        val_dmatrix = local.shard_matrix(val_dmatrix, topo)
    logger.info(
        "Train matrix has %d rows and %d columns",
        train_dmatrix.num_row,
        train_dmatrix.num_col,
    )
    if val_dmatrix:
        logger.info("Validation matrix has %d rows", val_dmatrix.num_row)

    # several boosting rounds a device dispatch by default, as the JAX
    # package batches them, where no artifact must land every round (the
    # checkpoints and the SIGTERM save of intermediate models do). Metrics
    # without a device form keep the batch and print once a dispatch
    # (models/booster.py); an explicit _rounds_per_dispatch always wins
    if (not checkpoint_dir and save_model_on_termination != "true"
            and "_rounds_per_dispatch" not in train_cfg):
        train_cfg["_rounds_per_dispatch"] = int(
            os.environ.get("SM_ROUNDS_PER_DISPATCH_DEFAULT", "8"))

    def callbacks_for(fold=None, num_rows=None):
        return get_callbacks(
            model_dir=model_dir,
            checkpoint_dir=checkpoint_dir,
            early_stopping_data_name=early_stopping_data_name,
            early_stopping_metric=early_stopping_metric,
            early_stopping_rounds=early_stopping_rounds,
            save_model_on_termination=save_model_on_termination,
            is_master=is_master,
            fold=fold,
            num_round=num_round,
            num_rows=num_rows,
            train_cfg=train_cfg,
        )

    try:
        kfold = train_cfg.pop("_kfold", None)
        if kfold is None:
            from . import elastic

            watchlist = [(train_dmatrix, "train")]
            if val_dmatrix is not None:
                watchlist.append((val_dmatrix, "validation"))
            agreed = {}

            def _train_once():
                xgb_model, iteration, callbacks = callbacks_for(num_rows=train_dmatrix.num_row)
                if "resume" in agreed:
                    xgb_model, iteration = agreed.pop("resume")
                try:
                    with xla_trace(), span("train", emit=True):
                        return booster.train(
                            train_cfg,
                            train_dmatrix,
                            num_boost_round=num_round - iteration,
                            evals=watchlist,
                            feval=configured_feval,
                            device=device,
                            callbacks=callbacks,
                            verbose_eval=False,
                            xgb_model=xgb_model,
                            group=_training_group(),
                        )
                except elastic.ReformRequested:
                    # the abandoned generation's threads (the round
                    # watchdog's monitor, the checkpoint deleter) must not
                    # outlive it
                    elastic.drain_callbacks(callbacks)
                    raise

            def _on_reform(new_hosts, current_host):
                # with local ranks, the leader's verdict to its workers once
                # the survivors' rendezvous has committed, and every rank's
                # place at its host's new index; then the process group (as
                # at start-up), the planes over the survivors (the leader's),
                # and the one resume point
                from ..telemetry import tracing
                from .watchdog import start_abort_plane

                rank = world = None
                topo_now = local.topology()
                if topo_now is not None:
                    if topo_now.is_leader:
                        t = elastic.membership_log()[-1]
                        local.relay_to_workers({
                            "verb": "reform", "generation": t["generation"],
                            "survivors": t["hosts"], "epoch": t["epoch"],
                            "reason": t["reason"]})
                    topo_now = topo_now.after_shrink(new_hosts, current_host)
                    local.set_topology(topo_now)
                    rank, world = topo_now.global_rank, topo_now.world_size
                distributed.reform_process_group(new_hosts, current_host, device,
                                                 elastic.generation(), rank=rank,
                                                 world_size=world)
                if not local.is_worker():
                    start_abort_plane(new_hosts, current_host)
                    start_cluster_telemetry(new_hosts, current_host)
                    tracing.set_rank(sorted(new_hosts).index(current_host))
                    fleet.start_fleet_plane(new_hosts, current_host)
                if "dir" not in agreed:
                    agreed["dir"] = tempfile.mkdtemp(prefix="elastic-resume-")
                agreed["resume"] = _agree_resume_point(checkpoint_dir, device, agreed["dir"])

            try:
                bst = elastic.supervised_train(_train_once, on_reform=_on_reform)
            finally:
                if "dir" in agreed:
                    shutil.rmtree(agreed["dir"], ignore_errors=True)
            if multi_rank:
                _stop_cluster_planes()
        else:
            bst = _cross_validate(
                train_cfg, train_val_dmatrix, kfold, num_round, configured_feval,
                callbacks_for, checkpoint_dir, early_stopping_rounds,
                save_model_on_termination, device, _training_group(),
            )
            if multi_rank:
                _stop_cluster_planes()
    except Exception as e:
        for customer_error_message in CUSTOMER_ERRORS:
            if customer_error_message in str(e):
                raise exc.UserError(str(e))
        if isinstance(e, (exc.UserError, exc.PlatformError)):
            raise
        raise exc.AlgorithmError("XGB train call failed with exception:\n {}".format(e))

    os.makedirs(model_dir, exist_ok=True)
    if is_master:
        from ..data import streaming

        try:
            # the chunks the job skipped, beside the model (absent when none)
            qpath = streaming.write_quarantine_manifest(model_dir)
            if qpath:
                logger.warning("ingest quarantine manifest written to %s", qpath)
        except OSError as e:
            logger.warning("could not write ingest quarantine manifest: %s", e)
        with span("model_save", emit=True):
            if not isinstance(bst, list):
                model_location = os.path.join(model_dir, MODEL_NAME)
                _save_with_manifest(bst, model_location, train_cfg)
                logger.debug("Stored trained model at %s", model_location)
            else:
                for fold, fold_booster in enumerate(bst):
                    model_location = os.path.join(model_dir, "{}-{}".format(MODEL_NAME, fold))
                    _save_with_manifest(fold_booster, model_location, train_cfg)
                    logger.debug("Stored trained model %d at %s", fold, model_location)
    if local.is_worker():
        # the host's trace is its leader's lane, as under JAX (one process
        # a host)
        return bst
    # end-of-job trace export (SM_TRACE): this rank's Chrome trace beside the
    # model unless SM_TRACE_EXPORT_DIR names a directory; best-effort
    from ..telemetry import tracing

    try:
        tracing.export_traces(default_dir=model_dir)
    except Exception:
        logger.exception("trace export failed; training result unaffected")
    # the fleet merge rides next to the per-rank exports: every rank flushes
    # its shipper, rank 0 writes trace-fleet.json (inert with the plane off)
    try:
        fleet.export_fleet_trace(default_dir=model_dir)
    except Exception:
        logger.exception("fleet trace export failed; training result unaffected")
    return bst


def _save_with_manifest(model, model_location, train_cfg):
    """Save ``model`` and its manifest (digest, config fingerprint, the
    elastic membership log after a shrink, the streaming ingest's
    quarantine record where the job skipped chunks, and
    under ``SM_MODEL_TELEMETRY`` the learning-curve summary and the drift
    baseline), which serving digest-verifies at load. The manifest is
    best-effort: an ``OSError`` writing it warns and the model loads
    manifest-less."""
    model.save_model(model_location)
    try:
        from ..data import streaming
        from ..telemetry import model as model_telemetry
        from ..utils import integrity

        from . import elastic

        integrity.write_manifest(
            model_location,
            fingerprint=integrity.config_fingerprint(train_cfg),
            membership_log=elastic.membership_log() or None,
            quarantine=streaming.quarantine_record(),
            learning=model_telemetry.learning_summary(),
            drift_baseline=model_telemetry.drift_baseline(),
        )
    except OSError as e:
        logger.warning("could not write model manifest for %s: %s", model_location, e)


class _EvalsRecorder:
    """Callback: the fold's metric log, for the CV means."""

    def __init__(self):
        self.log = {}

    def after_iteration(self, model, epoch, evals_log):
        self.log = {k: dict(v) for k, v in evals_log.items()}
        return False


def _cross_validate(train_cfg, train_val_dmatrix, kfold, num_round, configured_feval,
                    callbacks_for, checkpoint_dir, early_stopping_rounds,
                    save_model_on_termination, device, group=None):
    """Repeated k-fold CV over the train+validation rows -> the fold models,
    fold by fold; writes the out-of-fold predictions and prints the CV
    metric lines. Across hosts (``group``) the rows are this host's, every
    fold trains over the group, and the fold-parallel path is skipped (the
    JAX package's ``_try_parallel_cv`` declines more than one process)."""
    num_cv_round = train_cfg.pop("_num_cv_round", 1)
    topo = local.topology()
    # a local rank that is not its host's leader trains its share of each
    # fold and leaves the predictions and the CV lines to the leader
    leader = not local.is_worker()
    logger.info(
        "Run %s-round of %s-fold cross validation with %s rows",
        num_cv_round,
        kfold,
        train_val_dmatrix.num_row,
    )
    bst = []
    evals_results = []
    num_class = train_cfg.get("num_class", None)
    objective = train_cfg.get("objective") or ""
    classification_problem = bool(num_class) or objective.startswith("binary:")
    y = train_val_dmatrix.get_label() if classification_problem else None
    random_state = None
    if topo is not None:
        # the local ranks of a host split its rows identically: the
        # leader's draw of a seed, sent to its workers
        from ..parallel import collectives

        seed = np.random.randint(0, 2**31 - 1) if leader else 0
        seeds = collectives.host_all_gather(np.asarray([seed], np.int64), group, device)
        random_state = int(seeds[topo.host_index * topo.local_size][0])
        logger.info("k-fold splits of the host's rows seeded with %d", random_state)
    rkf = (
        RepeatedStratifiedKFold(n_splits=kfold, n_repeats=num_cv_round,
                                random_state=random_state)
        if y is not None
        else RepeatedKFold(n_splits=kfold, n_repeats=num_cv_round, random_state=random_state)
    )
    val_pred = ValidationPredictionRecorder(
        y_true=train_val_dmatrix.get_label(),
        num_cv_round=num_cv_round,
        classification=classification_problem,
        output_data_dir=os.environ[SM_OUTPUT_DATA_DIR],
    ) if leader else None
    splits = list(rkf.split(X=range(train_val_dmatrix.num_row), y=y))

    parallel = None
    if group is None:
        parallel = _try_parallel_cv(
            train_cfg, train_val_dmatrix, splits, num_round, kfold, checkpoint_dir,
            early_stopping_rounds, configured_feval, save_model_on_termination, device,
        )
    if parallel is not None:
        bst, evals_results = parallel
        for k, (_train_idx, val_idx) in enumerate(splits):
            cv_val = train_val_dmatrix.slice(val_idx)
            val_pred.record(val_idx, bst[k].predict(cv_val.features))
            if (k + 1) % kfold == 0:
                logger.info("The metrics of round %d cross validation", (k + 1) // kfold)
                print_cv_metric(num_round, evals_results[k + 1 - kfold: k + 1])
    else:
        for train_idx, val_idx in splits:
            if topo is not None:
                # this rank's share of the fold: contiguous runs of the
                # fold's rows; the leader's shard carries the whole fold's
                # training rows for the host's cuts
                cv_train = train_val_dmatrix.slice(local.shard_indices(train_idx, topo))
                cv_train.host_rows = train_val_dmatrix.slice(train_idx) if leader else None
                cv_val = train_val_dmatrix.slice(local.shard_indices(val_idx, topo))
            else:
                cv_train = train_val_dmatrix.slice(train_idx)
                cv_val = train_val_dmatrix.slice(val_idx)
            xgb_model, iteration, callbacks = callbacks_for(fold=len(bst),
                                                            num_rows=cv_train.num_row)
            recorder = _EvalsRecorder()
            logger.info("Train cross validation fold %d", (len(bst) % kfold) + 1)
            fold_booster = booster.train(
                train_cfg,
                cv_train,
                num_boost_round=num_round - iteration,
                evals=[(cv_train, "train"), (cv_val, "validation")],
                feval=configured_feval,
                device=device,
                callbacks=callbacks + [recorder],
                verbose_eval=False,
                xgb_model=xgb_model,
                group=group,
            )
            bst.append(fold_booster)
            evals_results.append(recorder.log)
            if not leader:
                continue
            if topo is not None:
                # every rank holds the same model: the leader predicts all
                # of its host's held-out rows, in channel order
                cv_val = train_val_dmatrix.slice(val_idx)
            val_pred.record(val_idx, fold_booster.predict(cv_val.features))
            if len(bst) % kfold == 0:
                logger.info("The metrics of round %d cross validation", len(bst) // kfold)
                print_cv_metric(num_round, evals_results[-kfold:])
    if not leader:
        return bst
    val_pred.save()
    if num_cv_round > 1:
        logger.info("The overall metrics of %s-round cross validation", num_cv_round)
        print_cv_metric(num_round, evals_results)
    return bst


def _try_parallel_cv(train_cfg, train_val_dmatrix, splits, num_round, kfold, checkpoint_dir,
                     early_stopping_rounds, configured_feval, save_model_on_termination,
                     device):
    """The fold-parallel path (``models/cv_parallel``) -> (forests,
    evals_results), or None where it does not apply: it needs no per-fold
    host work mid-training (checkpoints, early stopping, the SIGTERM save,
    a feval) and metrics with a device form. ``GRAFT_PARALLEL_CV=0`` turns
    it off, as in the JAX package."""
    if os.environ.get("GRAFT_PARALLEL_CV", "1") != "1":
        return None
    if checkpoint_dir or early_stopping_rounds or configured_feval is not None:
        return None
    if save_model_on_termination == "true":
        return None
    from ..models.cv_parallel import parallel_cv_supported, train_cv_parallel

    try:
        cfg = booster.TrainConfig(dict(train_cfg))
    except exc.UserError:
        return None  # the sequential path raises it where it does

    def forest_factory():
        return Forest(
            objective_name=cfg.objective,
            objective_params={k: v for k, v in cfg.objective_params.items()
                              if k in booster.OBJECTIVE_PARAM_KEYS},
            base_score=cfg.base_score,
            num_feature=train_val_dmatrix.num_col,
            num_class=cfg.num_class,
            device=device,
        )

    metric_names = booster._eval_metric_names(cfg, forest_factory().objective())
    if not parallel_cv_supported(cfg, metric_names, False):
        return None
    logger.info("Training %d CV folds side by side on one device", len(splits))
    forests, evals_results = train_cv_parallel(
        cfg, train_val_dmatrix, splits, num_round, metric_names, forest_factory, device)
    # per-fold per-round metric lines in the sequential monitor's format
    for k, res in enumerate(evals_results):
        logger.info("Train cross validation fold %d", (k % kfold) + 1)
        for r in range(num_round):
            parts = [
                "{}-{}:{:.5f}".format(data_name, metric_name, res[data_name][metric_name][r])
                for data_name in res
                for metric_name in res[data_name]
            ]
            print("[{}]\t{}".format(r, "\t".join(parts)), flush=True)
    return forests, evals_results


def print_cv_metric(num_round, evals_results):
    """One stdout line with each metric's mean over the folds."""
    report = "[{}]".format(num_round)
    data_names = evals_results[0].keys()
    metric_names = evals_results[0]["train"].keys()
    for metric_name in metric_names:
        for data_name in data_names:
            values = [r[data_name][metric_name][-1] for r in evals_results]
            report += "\t{}-{}:{:.5f}".format(data_name, metric_name, float(np.mean(values)))
    print(report, flush=True)
