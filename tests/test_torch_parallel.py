"""Data parallelism of the port (`parallel/mesh.py`) in worlds of two ranks on
the CPU, under gloo, each rank a spawned process (tests/torch_parallel_util.py:
every world is joined with a time limit, its stragglers killed, a rank's
traceback raised here).

The reference semantics (the JAX package's `train/trainer.py`): the R
replica groups' losses are SUMMED, each group normalises with its own batch
statistics, the BN running-statistics updates are AVERAGED over the groups,
metrics are summed, and `clip_norm` clips the global norm. A world of N
ranks, each given its contiguous share of the groups, must take the step
that R groups take one after another in one process, and the JAX trainer's
step with the same R.

Stated tolerances. Against the port's one-process step, with one group a
rank (R = 2): BIT-EQUAL (the two groups' gradients meet in one addition
either way). With two groups a rank (R = 4) the world adds (g0 + g1) + (g2 +
g3) where one process accumulates in autograd's order: 1e-5 of each leaf's
largest value (measured: 4.0e-6 in the meta momentum, 2.0e-7 in the
parameters). The ranks run with the parent's thread count, since a CPU
convolution splits its sums over the threads. Against the JAX trainer:
tests/test_torch_trainer.py's rtol 1e-4 with a floor of 1e-4 of the leaf's
largest value, for every case. The plain step with R = 4 (groups of 2 images
at 96 px) is the one that needs exact BN sums: on its batch the variance
`q/n - mean^2` cancels, and a float32 `torch.sum` put the port 9.1e-4 of the
leaf's largest value off the JAX trainer at the first BN's beta momentum,
where the plain CPU `bn_sums`, which sums in float64, is as close as XLA's
reduction (1.0e-5 from exact). Both ranks end every step with the same
bits.

The sharded sweeps (FSD_EVAL_MESH=2, batches 5 and 8, so a padded tail and
an even split) write files line-equal to the port's one-process sweep: the
same lines, ids, boxes and order, the printed floats within 1e-5 (measured:
identical files, but for 62 of 13,640 lines of the ensemble sweep at batch
5, whose tail of 2 images runs as one image a rank, where the CPU's kernels
for a batch of one round otherwise: 2e-6 at most, in the last printed
digit). Against the
JAX package's 2-device mesh sweep on its virtual CPU devices they agree
within tests/test_torch_plain_valid.py's 1e-4."""

import os

import jax
import numpy as np
import pytest
import torch

from fewshot_detection_tpu.cli.common import resolve_configs as j_resolve
from fewshot_detection_tpu.config import parse_cfg as j_parse_cfg
from fewshot_detection_tpu.eval import valid as j_valid
from fewshot_detection_tpu.models import meta as jm
from fewshot_detection_tpu.models.spec import build_spec as j_build_spec
from fewshot_detection_tpu.train import MetaTrainer as JMetaTrainer
from fewshot_detection_tpu.train import PlainTrainer as JPlainTrainer
from fewshot_detection_tpu_torch.cli.common import resolve_configs
from fewshot_detection_tpu_torch.config import parse_cfg
from fewshot_detection_tpu_torch.eval import valid as t_valid
from fewshot_detection_tpu_torch.models import meta as tm
from fewshot_detection_tpu_torch.models import weights_io
from fewshot_detection_tpu_torch.models.convert import to_jax_momentum, to_jax_params
from fewshot_detection_tpu_torch.models.darknet import init_params
from fewshot_detection_tpu_torch.models.spec import build_spec
from fewshot_detection_tpu_torch.parallel import batch_sharding, replicated_sharding, shard_batch
from fewshot_detection_tpu_torch.parallel.mesh import Mesh, pad_to_ranks
from fewshot_detection_tpu_torch.train.optim import (
    sgd_update,
    tree_leaves_with_path,
    tree_map,
)

import torch_parallel_util as pu
from synth import make_voc_like
from test_e2e_plain import TINY_PLAIN_CFG
from torch_port_util import (
    REPO,
    assert_results_close,
    cfg,
    in_env,
    randomize_bn,
    read_results,
    to_jnp_tree,
)

R4_FLOOR = 1e-5
JAX_RTOL = JAX_FLOOR = 1e-4
SWEEP_TOL = 1e-4
SHARD_TOL = 1e-5
N_CLS, META_SIZE, PLAIN_SIZE = 3, 64, 96
NETS = ("darknet", "learnet")
METRICS = ("nGT", "nCorrect", "nProposals", "loss_x", "loss_y", "loss_w", "loss_h",
           "loss_conf", "loss_cls", "loss")
META_CFGS = (cfg("tiny_darknet_dynamic.cfg"), cfg("tiny_reweighting.cfg"))


def _scaled_mom(rng, tree):
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(np.float32), tree)


def _meta_state():
    spec = tm.MetaSpec(*(build_spec(parse_cfg(p)) for p in META_CFGS))
    params = tm.init_meta_params(spec, 0)
    rng = np.random.default_rng(1)
    for k in NETS:
        for p in params[k]:
            if p and "w" in p:
                p["w"] = p["w"] * 2.0  # keep activations O(1) through the stack
        randomize_bn(params[k], rng)
    mom = {k: [None if p is None else _scaled_mom(rng, p) for p in params[k]] for k in NETS}
    return params, mom


def _meta_batch(seed, R, b=2, group_scale=None):
    r = np.random.RandomState(seed)
    target = np.zeros((R, b, N_CLS, 50, 5), np.float32)
    for g in range(R):
        for i in range(b):
            c = r.randint(N_CLS)
            target[g, i, c, 0] = [c, r.uniform(0.3, 0.7), r.uniform(0.3, 0.7), 0.3, 0.3]
    keep = np.ones((R, b * N_CLS), np.float32)
    keep[:, 1] = (target.reshape(R, b * N_CLS, -1)[:, 1] != 0).any(-1)
    x = r.rand(R, b, META_SIZE, META_SIZE, 3).astype(np.float32)
    if group_scale is not None:  # groups whose images, so BN statistics, differ
        x = x * np.asarray(group_scale, np.float32).reshape(R, 1, 1, 1, 1)
    return {"x": x,
            "metax": r.rand(R, N_CLS, META_SIZE, META_SIZE, 3).astype(np.float32),
            "mask": (r.rand(R, N_CLS, META_SIZE, META_SIZE, 1) > 0.5).astype(np.float32),
            "target": target, "keep": keep}


def _plain_state(plain_cfg):
    spec = build_spec(parse_cfg(plain_cfg))
    params = init_params(spec, 0)
    rng = np.random.default_rng(1)
    for p in params:
        if p and "w" in p:
            p["w"] = p["w"] * 2.0
    randomize_bn(params, rng)
    return params, [None if p is None else _scaled_mom(rng, p) for p in params]


def _plain_batch(seed, R, b=2):
    r = np.random.RandomState(seed)
    target = np.zeros((R, b, 50, 5), np.float32)
    for g in range(R):
        for i in range(b):
            for j in range(r.randint(1, 3)):
                target[g, i, j] = [r.randint(20), r.uniform(0.3, 0.7), r.uniform(0.3, 0.7),
                                   r.uniform(0.1, 0.4), r.uniform(0.1, 0.4)]
    keep = np.ones((R, b), np.float32)
    keep[0, -1] = 0.0
    return {"x": r.rand(R, b, PLAIN_SIZE, PLAIN_SIZE, 3).astype(np.float32),
            "target": target, "keep": keep}


def _one_process_step(case, groups=None):
    """The case's steps in one process with every group (or the groups
    `groups` only) run one after another: numpy (params, mom, metrics)."""
    spec, trainer = pu.make_trainer(case)
    params, mom = pu.torch_state(case, spec)
    metrics = []
    for batch, seen, lr in case["steps"]:
        if groups is not None:
            batch = {k: v[groups] for k, v in batch.items()}
        params, mom, m = trainer.step(params, mom, batch, seen, lr)
        metrics.append(pu.numpy_tree(m))
    return pu.numpy_tree(params), pu.numpy_tree(mom), metrics


def _grad_norms(case, halves):
    """The global gradient norm of the case's first step over all groups,
    and each rank's own over its half."""
    spec, trainer = pu.make_trainer(case)
    params, _ = pu.torch_state(case, spec)
    batch, seen, _ = case["steps"][0]

    def norm(b):
        g = trainer.loss_and_grads(params, b, seen)[1]
        return float(torch.sqrt(sum(t.square().sum() for _, t in tree_leaves_with_path(g))))

    return norm(batch), [norm({k: v[h] for k, v in batch.items()}) for h in halves]


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_cases")
    plain_cfg = str(root / "tiny_plain.cfg")
    with open(plain_cfg, "w") as f:
        f.write(TINY_PLAIN_CFG)
    mp, mm = _meta_state()
    pp, pm = _plain_state(plain_cfg)
    meta = {"kind": "meta", "cfgs": META_CFGS, "weight_decay": 5e-4, "clip_norm": 0.0,
            "params": mp, "mom": mm}
    plain = {"kind": "plain", "cfgs": (plain_cfg,), "weight_decay": 5e-4, "clip_norm": 0.0,
             "params": pp, "mom": pm}
    out = {
        "meta_r2": {**meta, "steps": [(_meta_batch(10, 2), 20004, 1e-4),
                                      (_meta_batch(11, 2), 20008, 1e-4)]},
        "meta_r4": {**meta, "steps": [(_meta_batch(12, 4), 20008, 1e-4),
                                      (_meta_batch(13, 4), 20016, 1e-4)]},
        "meta_bn_groups_differ": {**meta, "steps": [
            (_meta_batch(14, 2, group_scale=(1.0, 0.25)), 20004, 1e-4)]},
        "meta_clip": {**meta, "steps": [(_meta_batch(15, 2), 20004, 1e-3)]},
        "plain_r2": {**plain, "steps": [(_plain_batch(20, 2), 20004, 1e-4),
                                        (_plain_batch(21, 2), 20008, 1e-4)]},
        "plain_r4": {**plain, "steps": [(_plain_batch(22, 4), 20008, 1e-4)]},
        "plain_clip": {**plain, "steps": [(_plain_batch(23, 2), 20004, 1e-3)]},
    }
    # a clip that binds on the global norm AND on each rank's own: clipping
    # each rank's gradient would then give another step
    for name in ("meta_clip", "plain_clip"):
        total, own = _grad_norms(out[name], [slice(0, 1), slice(1, 2)])
        out[name]["clip_norm"] = 0.5 * min(own)
        out[name]["norms"] = (total, own)
    return out


@pytest.fixture(scope="module")
def world_steps(cases, tmp_path_factory):
    store = str(tmp_path_factory.mktemp("dp_store") / "store")
    send = {k: {kk: vv for kk, vv in v.items() if kk != "norms"} for k, v in cases.items()}
    return pu.run_world(pu.step_cases, (send,), n=2, store=store)


@pytest.fixture(scope="module")
def one_process(cases):
    return {name: _one_process_step(case) for name, case in cases.items()}


def _leaves(tree):
    return dict(tree_leaves_with_path(tree))


def _assert_trees_close(got, want, floor, what):
    """Every leaf within `floor` of its largest value; 0: bit-equal."""
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for path in w:
        np.testing.assert_allclose(g[path], w[path], rtol=0,
                                   atol=floor * np.abs(w[path]).max(),
                                   err_msg=f"{what}{path}")


CASES = ["meta_r2", "meta_r4", "meta_bn_groups_differ", "meta_clip", "plain_r2", "plain_r4",
         "plain_clip"]


@pytest.mark.parametrize("name", CASES)
def test_both_ranks_end_with_the_same_bits(world_steps, name):
    (p0, m0, met0, coll0), (p1, m1, met1, coll1) = (w[name] for w in world_steps)
    for a, b in ((p0, p1), (m0, m1), (met0, met1)):
        la, lb = _leaves(a), _leaves(b)
        assert la.keys() == lb.keys()
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=str(k))
    # one flat buffer a dtype: float32 (gradients, BN sums, losses) and
    # int64 (the counts among the metrics)
    assert coll0 == coll1 == [2] * len(coll0)


@pytest.mark.parametrize("name", CASES)
def test_world_step_equals_the_one_process_step(world_steps, one_process, name):
    params, mom, metrics, _ = world_steps[0][name]
    want_p, want_m, want_metrics = one_process[name]
    floor = R4_FLOOR if name.endswith("_r4") else 0.0  # else bit-equal
    _assert_trees_close(params, want_p, floor, "params")
    _assert_trees_close(mom, want_m, floor, "momentum")
    for got, want in zip(metrics, want_metrics):
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=floor, err_msg=k)


def _jax_steps(case):
    if case["kind"] == "meta":
        jspec = jm.MetaSpec(*(j_build_spec(j_parse_cfg(p)) for p in case["cfgs"]))
        jt = JMetaTrainer(jspec, weight_decay=case["weight_decay"], clip_norm=case["clip_norm"],
                          donate=False)
        jp = {k: to_jnp_tree(case["params"][k]) for k in NETS}
        jmom = {k: to_jnp_tree(case["mom"][k]) for k in NETS}
    else:
        jspec = j_build_spec(j_parse_cfg(case["cfgs"][0]))
        jt = JPlainTrainer(jspec, weight_decay=case["weight_decay"],
                           clip_norm=case["clip_norm"], donate=False)
        jp, jmom = to_jnp_tree(case["params"]), to_jnp_tree(case["mom"])
    metrics = []
    for batch, seen, lr in case["steps"]:
        jp, jmom, jmet = jt.step(jp, jmom, batch, seen, lr)
        metrics.append(jmet)
    return jp, jmom, metrics


def _as_jax_layout(case, tree, momentum: bool):
    """A numpy tree of the port's layout in the JAX package's (HWIO)."""
    spec, _ = pu.make_trainer(case)
    conv = to_jax_momentum if momentum else to_jax_params
    t = tree_map(torch.from_numpy, tree)
    if case["kind"] == "meta":
        return {k: conv(getattr(spec, k), t[k]) for k in NETS}
    return conv(spec, t)


@pytest.mark.parametrize("name", CASES)
def test_world_step_equals_the_jax_trainer(cases, world_steps, name):
    case = cases[name]
    params, mom, metrics, _ = world_steps[0][name]
    jp, jmom, jmetrics = _jax_steps(case)
    for got, want in ((_as_jax_layout(case, params, False), jp),
                      (_as_jax_layout(case, mom, True), jmom)):
        g = _leaves(got)
        w = _leaves(jax.tree_util.tree_map(np.asarray, want))
        assert g.keys() == w.keys() and len(g) > 10
        for path in w:
            np.testing.assert_allclose(g[path], w[path], rtol=JAX_RTOL,
                                       atol=JAX_FLOOR * np.abs(w[path]).max(),
                                       err_msg=str(path))
    for got, want in zip(metrics, jmetrics):
        for k in METRICS:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("name", ["meta_clip", "plain_clip"])
def test_clip_is_of_the_global_norm(cases, world_steps, one_process, name):
    """The clip binds on the global norm and on each rank's own; a world
    that clipped each rank's gradient before the sum would take another
    step, far outside the tolerance that the world's step keeps."""
    case = cases[name]
    total, own = case["norms"]
    assert case["clip_norm"] < min(own) and case["clip_norm"] < total
    spec, trainer = pu.make_trainer({**case, "clip_norm": 0.0})
    params, mom = pu.torch_state(case, spec)
    batch, seen, lr = case["steps"][0]
    grads, bns = None, []
    for half in (slice(0, 1), slice(1, 2)):
        _, g, bn, _ = trainer.loss_and_grads(params, {k: v[half] for k, v in batch.items()},
                                             seen)
        norm = torch.sqrt(sum(t.square().sum() for _, t in tree_leaves_with_path(g)))
        g = tree_map(lambda t: t * min(1.0, case["clip_norm"] / float(norm)), g)
        grads = g if grads is None else tree_map(torch.add, grads, g)
    sgd_update(params, grads, mom, lr, momentum=trainer.momentum,
               weight_decay=trainer.weight_decay,
               decay_bn_and_bias=trainer._DECAY_BN_AND_BIAS)
    per_rank = pu.numpy_tree(mom)
    got = world_steps[0][name][1]
    want = one_process[name][1]
    scale = max(float(np.abs(v).max()) for v in _leaves(want).values())
    assert pu.tree_max_abs(got, want) == 0.0
    assert pu.tree_max_abs(per_rank, want) > 1e-2 * scale


def test_running_statistics_are_the_mean_over_groups(world_steps, one_process, cases):
    """Groups with other images give other batch statistics: the running
    statistics after the step are their mean (the one-process step's), not
    either group's (DDP would broadcast rank 0's buffers)."""
    name = "meta_bn_groups_differ"
    got = world_steps[0][name][0]
    only_first = _one_process_step(cases[name], groups=slice(0, 1))[0]
    only_second = _one_process_step(cases[name], groups=slice(1, 2))[0]
    stats = [p for p, _ in tree_leaves_with_path(got) if p[-1] in ("mean", "var")]
    assert len(stats) > 10
    g, w = _leaves(got), _leaves(one_process[name][0])
    a, b = _leaves(only_first), _leaves(only_second)
    for p in stats:
        np.testing.assert_array_equal(g[p], w[p])
    first_layer = [p for p in stats if p[0] == "darknet" and p[1] == 0]
    for p in first_layer:
        assert np.abs(a[p] - b[p]).max() > 1e-3  # the groups really differ
        np.testing.assert_allclose(g[p], (a[p] + b[p]) / 2, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the mesh's helpers in one process
# ---------------------------------------------------------------------------


def test_sharding_helpers_split_the_leading_axis():
    mesh = Mesh(size=2, rank=1, device=torch.device("cpu"), backend="gloo")
    assert batch_sharding(mesh, 4) == slice(2, 4)
    assert replicated_sharding(mesh) == 0
    tree = {"x": np.arange(8).reshape(4, 2), "y": torch.arange(4)}
    got = shard_batch(mesh, tree)
    np.testing.assert_array_equal(got["x"], [[4, 5], [6, 7]])
    assert got["y"].tolist() == [2, 3]
    with pytest.raises(ValueError, match="does not split"):
        batch_sharding(mesh, 3)
    local, n = pad_to_ranks(mesh, np.arange(5).reshape(5, 1))
    assert n == 5 and local.ravel().tolist() == [3, 4, 4]  # the last image repeated


def test_make_mesh_alone_is_a_world_of_one():
    """A process started alone makes a world of one (gloo on the CPU), whose
    all-reduce is the identity; a mesh of two devices there raises, naming
    torchrun, and so does FSD_EVAL_MESH=3."""
    out = pu.run_world(pu.mesh_of_one, n=1)
    assert out == [(1, 0, "gloo", 2, True, True, [1.0, 1.0, 1.0], [2])]


# ---------------------------------------------------------------------------
# the CLI in a world of two
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_cli")
    d = make_voc_like(str(root / "voc"), n_images=24, seed=0)
    dk = str(root / "tiny_dd.cfg")
    with open(os.path.join(REPO, "cfg/tiny_darknet_dynamic.cfg")) as f:
        txt = f.read().replace("learning_rate=0.001", "learning_rate=0.0001")
    with open(dk, "w") as f:
        f.write(txt)
    ln = os.path.join(REPO, "cfg/tiny_reweighting.cfg")
    shot_dict = str(root / "traindict_3shot.txt")
    with open(d["traindict"]) as src, open(shot_dict, "w") as dst:
        dst.write(src.read())
    def datacfg(name, epochs, backup):
        path = str(root / name)
        with open(path, "w") as f:
            f.write("metayolo=1\nmetain_type=2\ndata=voc\nneg=1\nrand=0\nscale=0\n"
                    f"tuning=1\nmax_epoch={epochs}\nrepeat=1\ndynamic=0\n"
                    f"novel={REPO}/data/voc_novels.txt\nnovelid=0\n"
                    f"meta={shot_dict}\ntrain={d['train_list']}\nvalid={d['train_list']}\n"
                    f"backup={root}/{backup}\ngpus=0\n")
        return path

    spec = tm.MetaSpec(build_spec(parse_cfg(dk)), build_spec(parse_cfg(ln)))
    params = tm.init_meta_params(spec, 0)
    init_w = str(root / "init.weights")
    weights_io.save_weights(init_w, [spec.darknet, spec.learnet],
                            [params["darknet"], params["learnet"]], seen=0)
    return {"root": str(root), "argv": (datacfg("dp.data", 1, "backup"), dk, ln, init_w),
            "resume_argv": (datacfg("dp2.data", 2, "backup"), dk, ln, init_w),
            "one_argv": (datacfg("one2.data", 2, "one"), dk, ln, init_w),
            "backup": os.path.join(str(root), "backupfix_novel0_neg1")}


CLI_ENV = {"FSD_NOAUG": "0", "FSD_DTYPE": "float32", "FSD_INPUT_U8": "0", "FSD_REMAT": "0",
           "FSD_WORKERS": "0", "FSD_NATIVE": "0", "FSD_OVERLAP_METRICS": "0"}


@pytest.fixture(scope="module")
def cli_world(cli_ws):
    """One tuning epoch of train_meta_cli.main (the 3-shot list's 24 images:
    six steps of the cfg's batch 4, two groups of 2, one a rank) in a world of
    two that the CLI joins from torchrun's variables, with a full-state
    checkpoint after the epoch."""
    env = {**CLI_ENV, "FSD_ORBAX_DIR": os.path.join(cli_ws["root"], "ckpt")}
    return pu.run_world(pu.meta_cli, (cli_ws["argv"], env, True), n=2)


def test_cli_world_rank0_alone_writes_and_ranks_end_bit_equal(cli_ws, cli_world):
    (p0, lines0, w0), (p1, lines1, w1) = cli_world
    assert len(lines0) == 6 and lines1 == []  # one printer
    assert [int(l.split(":")[0]) for l in lines0] == [4, 8, 12, 16, 20, 24]  # the global batch
    assert w0 == ["000001.weights"] and w1 == []
    assert sorted(os.listdir(cli_ws["backup"])) == ["000001.weights"]
    assert sorted(os.listdir(os.path.join(cli_ws["root"], "ckpt"))) == ["ckpt_00000001"]
    la, lb = _leaves(p0), _leaves(p1)
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=str(k))


def test_cli_world_equals_one_process_with_two_groups(cli_ws, cli_world, monkeypatch, capsys):
    """The same clock, so the same episodes: one process running both groups
    one after another takes the world's steps, bit for bit."""
    import types

    from fewshot_detection_tpu_torch.cli import train_meta_cli

    monkeypatch.setattr(train_meta_cli, "time", types.SimpleNamespace(time=lambda: 1234.0))
    for k, v in CLI_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("FSD_ORBAX_DIR", raising=False)
    capsys.readouterr()
    params = train_meta_cli.main(*cli_ws["argv"], device="cpu", n_groups=2)
    lines = [l for l in capsys.readouterr().out.splitlines() if ": nGT " in l]
    assert lines == cli_world[0][1]
    _assert_trees_close(cli_world[0][0], pu.numpy_tree(params), 0.0, "params")


@pytest.fixture(scope="module")
def resumed_world(cli_ws, cli_world):
    """The world of two resumed from its checkpoint to a second epoch; a copy
    of the checkpoint taken first, for one process to resume from."""
    import shutil

    shutil.copytree(os.path.join(cli_ws["root"], "ckpt"), os.path.join(cli_ws["root"], "ckpt1"))
    env = {**CLI_ENV, "FSD_ORBAX_DIR": os.path.join(cli_ws["root"], "ckpt")}
    return pu.run_world(pu.meta_cli, (cli_ws["resume_argv"], env, True), n=2)


def test_cli_world_resumes_as_one_process_does(cli_ws, resumed_world, monkeypatch, capsys):
    """Every rank restores the checkpoint rank 0 wrote, so the resumed world
    continues bit-equal to one process resumed from the same state with the
    same two groups."""
    import types

    from fewshot_detection_tpu_torch.cli import train_meta_cli

    (p0, lines0, w0), (p1, lines1, w1) = resumed_world
    assert w0 == ["000002.weights"] and w1 == [] and lines1 == []
    assert [int(l.split(":")[0]) for l in lines0] == [28, 32, 36, 40, 44, 48]
    _assert_trees_close(p1, p0, 0.0, "rank 1")
    monkeypatch.setattr(train_meta_cli, "time", types.SimpleNamespace(time=lambda: 1234.0))
    for k, v in {**CLI_ENV, "FSD_ORBAX_DIR": os.path.join(cli_ws["root"], "ckpt1")}.items():
        monkeypatch.setenv(k, v)
    capsys.readouterr()
    params = train_meta_cli.main(*cli_ws["one_argv"], device="cpu", n_groups=2)
    assert [l for l in capsys.readouterr().out.splitlines() if ": nGT " in l] == lines0
    _assert_trees_close(p0, pu.numpy_tree(params), 0.0, "params")


# ---------------------------------------------------------------------------
# sharded sweeps under FSD_EVAL_MESH
# ---------------------------------------------------------------------------


def _datacfg(path, d, root, metayolo):
    with open(path, "w") as f:
        f.write((f"metayolo=1\nmetain_type=2\n" if metayolo else "metayolo=0\n") +
                "data=voc\nneg=1\nrand=0\n"
                f"novel={REPO}/data/voc_novels.txt\nnovelid=0\n"
                f"meta={d['traindict']}\ntrain={d['train_list']}\n"
                f"valid={d['train_list']}\nbackup={root}/backup\ngpus=0\n")
    return path


@pytest.fixture(scope="module")
def sweep_ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_sweeps")
    d = make_voc_like(str(root / "data"), n_images=22, classes_per_image=2, seed=3)
    plain_cfg = str(root / "tiny_plain.cfg")
    with open(plain_cfg, "w") as f:
        f.write(TINY_PLAIN_CFG)
    os.makedirs(root / "backup")
    plain_data = _datacfg(str(root / "plain.data"), d, root, metayolo=False)
    spec = build_spec(parse_cfg(plain_cfg))
    params = init_params(spec, 3)
    rng = np.random.default_rng(5)
    for p in params:
        if p and "w" in p:
            p["w"] = p["w"] * 2.45
    randomize_bn(params, rng)
    plain_w = str(root / "backup" / "000001.weights")
    weights_io.save_weights(plain_w, [spec], [params], seen=64)
    meta_data = _datacfg(str(root / "meta.data"), d, root, metayolo=True)
    mspec = tm.MetaSpec(*(build_spec(parse_cfg(p)) for p in META_CFGS))
    mparams = tm.init_meta_params(mspec, 5)
    for k in NETS:
        randomize_bn(mparams[k], rng)
    meta_w = str(root / "backup" / "000002.weights")
    weights_io.save_weights(meta_w, [mspec.darknet, mspec.learnet],
                            [mparams["darknet"], mparams["learnet"]], seen=64)
    runs = []
    for sweep, datacfg, cfgs, weights in (("run_valid", plain_data, (plain_cfg,), plain_w),
                                          ("run_valid_ensemble", meta_data, META_CFGS, meta_w)):
        for batch in (5, 8):
            runs.append({"sweep": sweep, "root": str(root), "datacfg": datacfg, "cfgs": cfgs,
                         "weights": weights, "batch": batch, "tag": f"dp{batch}_",
                         "env": {"FSD_EVAL_MESH": "2"}})
    refused = [{**runs[0], "tag": f"refused{i}_", "env": {"FSD_EVAL_MESH": v}}
               for i, v in enumerate(REFUSED)]
    return {"root": str(root), "runs": runs, "refused": refused}


@pytest.fixture(scope="module")
def sweep_world(sweep_ws, tmp_path_factory):
    store = str(tmp_path_factory.mktemp("dp_sweep_store") / "store")
    return pu.run_world(pu.sweeps, (sweep_ws["runs"] + sweep_ws["refused"],), n=2,
                        store=store)


def _one_process_sweep(run, tag, jax_mesh=False):
    env = {"FSD_EVAL_MESH": "2" if jax_mesh else None, "FSD_DEVICE_NMS_K": None}
    if run["sweep"] == "run_valid":
        if jax_mesh:
            opts, _, _, settings = j_resolve(run["datacfg"], *run["cfgs"])
            fn = lambda: j_valid.run_valid(opts, run["cfgs"][0], run["weights"], settings,  # noqa: E731
                                           outfile=tag, batch_size=run["batch"])
        else:
            opts, _, _, settings = resolve_configs(run["datacfg"], *run["cfgs"])
            fn = lambda: t_valid.run_valid(opts, run["cfgs"][0], run["weights"], settings,  # noqa: E731
                                           outfile=tag, batch_size=run["batch"], device="cpu")
    else:
        if jax_mesh:
            opts, dk, ln, settings = j_resolve(run["datacfg"], *run["cfgs"])
            fn = lambda: j_valid.run_valid_ensemble(opts, dk, ln, run["weights"], settings,  # noqa: E731
                                                    outfile=tag, batch_size=run["batch"])
        else:
            opts, dk, ln, settings = resolve_configs(run["datacfg"], *run["cfgs"])
            fn = lambda: t_valid.run_valid_ensemble(opts, dk, ln, run["weights"], settings,  # noqa: E731
                                                    outfile=tag, batch_size=run["batch"],
                                                    device="cpu")
    prefix = in_env(run["root"], env, lambda: os.path.abspath(fn()))
    return read_results(prefix, tag)


REFUSED = {"3": "FSD_EVAL_MESH=3 needs a world of 3 ranks", None: "set FSD_EVAL_MESH"}
SWEEPS = [("run_valid", 5), ("run_valid", 8), ("run_valid_ensemble", 5),
          ("run_valid_ensemble", 8)]


@pytest.mark.parametrize("i", range(4), ids=[f"{s}_batch{b}" for s, b in SWEEPS])
def test_sharded_sweep_files_equal_one_process_and_the_jax_mesh_sweep(sweep_ws, sweep_world,
                                                                      i):
    run = sweep_ws["runs"][i]
    (files, err), (other, other_err) = sweep_world[0][i], sweep_world[1][i]
    assert err is None and other_err is None and other is None  # rank 0 alone reads them
    assert assert_results_close(files, _one_process_sweep(run, f"one{i}_"), SHARD_TOL) > 1000
    want = _one_process_sweep(run, f"jax{i}_", jax_mesh=True)
    assert len(want) == 20
    assert assert_results_close(files, want, SWEEP_TOL) > 50


@pytest.mark.parametrize("value", REFUSED)
def test_eval_mesh_that_does_not_fit_the_world_raises(sweep_world, value):
    """FSD_EVAL_MESH=3 in a world of two, and a world of two with the switch
    unset (each rank would sweep everything into one set of files)."""
    i = len(SWEEPS) + list(REFUSED).index(value)
    for rank in (0, 1):
        files, err = sweep_world[rank][i]
        assert files is None
        assert REFUSED[value] in err
