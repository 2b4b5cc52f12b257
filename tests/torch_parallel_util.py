"""Worlds of several ranks for the data-parallel tests, on the CPU under gloo.

`run_world(target, args, n, store)` starts `n` spawned processes, each one
rank: it joins a gloo process group (through a `file://` store, or through
torchrun's environment variables on localhost) and returns `target(rank,
*args)`. The parent collects every rank's result with one time limit for
the whole world, kills the ranks still running at the limit, and raises a
rank's traceback as its own error, so no test can hang the suite.

The targets below import the port only (no JAX), so a rank starts in a few
seconds."""

import contextlib
import io
import multiprocessing
import os
import queue
import socket
import time
import traceback

import numpy as np

WORLD_SECONDS = 120


class RankFailed(RuntimeError):
    pass


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, store, env, threads, target, args, out):
    try:
        import torch
        import torch.distributed as dist

        # the parent's thread count: a CPU convolution splits its sums over
        # the threads, so another count rounds the weight gradients otherwise
        torch.set_num_threads(threads)
        os.environ.update(env)
        if store is not None:
            dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                    world_size=n)
        else:  # torchrun's variables: the port's make_mesh initialises the group
            os.environ.update({"RANK": str(rank), "LOCAL_RANK": str(rank),
                               "WORLD_SIZE": str(n)})
        try:
            out.put((rank, True, target(rank, *args)))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def run_world(target, args=(), n=2, store=None, env=None, seconds=WORLD_SECONDS) -> list:
    """[target(rank, *args) for each rank], from `n` spawned ranks. `store`:
    a path for the file:// store (it must not exist yet); None gives the
    ranks torchrun's variables (MASTER_ADDR 127.0.0.1, a free port) and
    lets the code under test initialise the group. `env` is set in every
    rank before it starts."""
    import torch

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    env = dict(env or {})
    if store is None:
        env.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())})
    procs = [ctx.Process(target=_rank_main, args=(r, n, store, env, torch.get_num_threads(), target, args, out),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + seconds
    results, errors = {}, {}
    try:
        while len(results) + len(errors) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) and out.empty():
                    # a rank died without a word (killed, or a crash in C)
                    time.sleep(0.5)
                    if out.empty():
                        break
                continue
            (results if ok else errors)[rank] = value
        for p in procs:
            p.join(max(0.0, min(10.0, deadline - time.monotonic())))
    finally:
        stragglers = [p for p in procs if p.is_alive()]
        for p in stragglers:
            p.kill()
            p.join(5)
    if errors:
        rank = min(errors)
        raise RankFailed(f"rank {rank} of {n} failed:\n{errors[rank]}")
    if len(results) < n:
        codes = [p.exitcode for p in procs]
        raise RankFailed(f"the world of {n} did not finish (limit {seconds} s) "
                         f"(results from ranks {sorted(results)}, exit codes {codes})")
    assert not any(p.is_alive() for p in procs)
    return [results[r] for r in range(n)]


def numpy_tree(tree):
    from fewshot_detection_tpu_torch.train.optim import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


# ---------------------------------------------------------------------------
# rank targets
# ---------------------------------------------------------------------------


def make_trainer(case, device="cpu", mesh=None):
    """(spec, trainer) of a case: {"kind": "meta" | "plain", "cfgs": paths,
    "weight_decay", "clip_norm"}."""
    from fewshot_detection_tpu_torch.config import parse_cfg
    from fewshot_detection_tpu_torch.models import meta as tm
    from fewshot_detection_tpu_torch.models.spec import build_spec
    from fewshot_detection_tpu_torch.train import MetaTrainer, PlainTrainer

    specs = [build_spec(parse_cfg(p)) for p in case["cfgs"]]
    kw = dict(weight_decay=case["weight_decay"], clip_norm=case["clip_norm"], device=device,
              mesh=mesh)
    if case["kind"] == "meta":
        spec = tm.MetaSpec(*specs)
        return spec, MetaTrainer(spec, **kw)
    return specs[0], PlainTrainer(specs[0], **kw)


def torch_state(case, spec, device="cpu"):
    """The case's numpy (params, momentum) as the port's trees on `device`."""
    from fewshot_detection_tpu_torch.models.convert import (
        from_jax_momentum,
        from_jax_params,
        require_grads,
    )

    if case["kind"] == "meta":
        nets = ("darknet", "learnet")
        params = require_grads({k: from_jax_params(getattr(spec, k), case["params"][k], device)
                                for k in nets})
        mom = {k: from_jax_momentum(getattr(spec, k), case["mom"][k], device) for k in nets}
        return params, mom
    return (require_grads(from_jax_params(spec, case["params"], device)),
            from_jax_momentum(spec, case["mom"], device))


def step_cases(rank, cases):
    """Each case's steps through a trainer on the world's mesh, every rank
    given its share of the groups: {name: (params, mom, metrics per step,
    collectives per step)} as numpy."""
    from fewshot_detection_tpu_torch.parallel import make_mesh, shard_batch

    mesh = make_mesh(2, device="cpu")
    out = {}
    for name, case in cases.items():
        spec, trainer = make_trainer(case, mesh=mesh)
        params, mom = torch_state(case, spec)
        metrics, collectives = [], []
        for batch, seen, lr in case["steps"]:
            before = mesh.collectives
            params, mom, m = trainer.step(params, mom, shard_batch(mesh, batch), seen, lr)
            collectives.append(mesh.collectives - before)
            metrics.append(numpy_tree(m))
        out[name] = (numpy_tree(params), numpy_tree(mom), metrics, collectives)
    return out


def meta_cli(rank, argv, env, pin_clock):
    """train_meta_cli.main in this rank: (its parameter tree as numpy, the
    loss lines it printed, the .weights files it wrote)."""
    import types

    from fewshot_detection_tpu_torch.cli import train_meta_cli
    from fewshot_detection_tpu_torch.models import weights_io

    os.environ.update(env)
    if pin_clock:
        train_meta_cli.time = types.SimpleNamespace(time=lambda: 1234.0)
    written = []
    save = weights_io.save_weights

    def recording_save(path, *a, **kw):
        written.append(os.path.basename(path))
        return save(path, *a, **kw)

    weights_io.save_weights = recording_save
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        params = train_meta_cli.main(*argv, device="cpu")
    lines = [l for l in buf.getvalue().splitlines() if ": nGT " in l]
    return numpy_tree(params), lines, written


def sweeps(rank, runs):
    """The sweeps of `runs` under FSD_EVAL_MESH in this rank: [(what rank 0
    read from the result files, or None; the error's text, or None)]."""
    import torch

    from fewshot_detection_tpu_torch.cli.common import resolve_configs
    from fewshot_detection_tpu_torch.eval import valid as t_valid
    from torch_port_util import read_results

    out = []
    for run in runs:
        cwd = os.getcwd()
        old = {k: os.environ.get(k) for k in run["env"]}
        os.chdir(run["root"])
        for k, v in run["env"].items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        try:
            cfgs = resolve_configs(run["datacfg"], *run["cfgs"])
            data_options, net, learnet, settings = cfgs
            if run["sweep"] == "run_valid":
                prefix = t_valid.run_valid(data_options, run["cfgs"][0], run["weights"],
                                           settings, outfile=run["tag"],
                                           batch_size=run["batch"], device="cpu")
            else:
                prefix = t_valid.run_valid_ensemble(data_options, net, learnet, run["weights"],
                                                    settings, outfile=run["tag"],
                                                    batch_size=run["batch"], device="cpu")
            files = read_results(os.path.abspath(prefix), run["tag"]) if rank == 0 else None
            out.append((files, None))
        except ValueError as e:
            out.append((None, str(e)))
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            os.chdir(cwd)
    return out


def tree_max_abs(a, b) -> float:
    """The largest |a - b| over two numpy trees of one shape."""
    from fewshot_detection_tpu_torch.train.optim import tree_leaves_with_path

    la, lb = dict(tree_leaves_with_path(a)), dict(tree_leaves_with_path(b))
    assert la.keys() == lb.keys()
    return max(float(np.abs(la[k].astype(np.float64) - lb[k]).max()) for k in la)


def mesh_of_one(rank):
    """make_mesh in a process started alone: (size, rank, backend,
    collectives after one all-reduce of two dtypes, whether a mesh of two
    raised naming torchrun, whether FSD_EVAL_MESH=3 raised)."""
    import torch
    import torch.distributed as dist

    from fewshot_detection_tpu_torch.eval import valid as t_valid
    from fewshot_detection_tpu_torch.parallel import make_mesh

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        os.environ.pop(k, None)
    two = three = False
    try:
        make_mesh(2, device="cpu")
    except ValueError as e:
        two = "torchrun --nproc_per_node=2" in str(e)
    mesh = make_mesh(device="cpu")
    tree = {"a": torch.ones(3), "n": torch.tensor([2])}
    mesh.all_reduce_sum(tree)
    os.environ["FSD_EVAL_MESH"] = "3"
    try:
        t_valid.eval_mesh("cpu")
    except ValueError as e:
        three = "FSD_EVAL_MESH=3 needs a world of 3 ranks" in str(e)
    return (mesh.size, mesh.rank, mesh.backend, mesh.collectives, two, three,
            tree["a"].tolist(), tree["n"].tolist())
