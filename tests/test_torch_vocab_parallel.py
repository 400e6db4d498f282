"""The layers that compute on their model-axis block, on the CPU: the
vocab-parallel embedding and loss, and the Mamba-1 / Mamba-2 channels.

  * ``layers.embed`` on a table split on V over the model axis (spawned
    gloo worlds 2 and 4, a 1 x world mesh) equals the reference's
    ``repro.models.layers.embed`` on the whole numpy table bit for bit,
    at fp32 and at bf16;
  * ``layers.lm_loss_chunked`` on a head split on V, with -1 labels and a
    remainder chunk, is within 1e-6 relative of the reference's
    ``lm_loss_chunked`` at fp32;
  * the gradients of h, of the embedding's block and of the head's block
    are within 1e-5 of each one's largest of the one-device autograd's
    (its block);
  * ``ssm.mamba1_block`` (reduced falcon-mamba-7b) and
    ``ssm.mamba2_block`` (reduced zamba2-1.2b) at fp32 compute on each
    rank's channels (``models.convert.shard_params``, then
    ``gather_params``) against the port's one-device block on the whole
    layer: the output within 1e-5, and the gradient of the input and of
    every leaf's block within 1e-5 of its largest - the backward of the
    activation exchange, of ``x_proj``'s sum and of the gated norm's sum
    of squares;
  * on abstract meshes (no process started), ``gather_params`` of every
    leaf whose layer computes on its model-axis block logs no model-axis
    gather in ``WIRE``: the embedding, ``lm_head`` and every SSM channel
    leaf keep their V / M rows or Di / M channels, and only their
    data-axis blocks are gathered.

Each world spawns one group that runs every check and saves what it saw.
"""

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.models.model_zoo import build

torch.set_num_threads(1)

WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 240
VOCAB, D = 512, 48
B, S, CHUNK = 3, 20, 8          # two chunks of 8 and a remainder of 4
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
BLOCK_TOL = 1e-5
SSM_ARCHS = ("falcon-mamba-7b", "zamba2-1.2b")


def _data():
    """The numpy inputs shared by the ranks and the reference: a table, a
    head, hidden states, tokens, labels (some -1) and two cotangents."""
    rng = np.random.default_rng(7)
    labels = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.2] = -1
    return dict(
        table=rng.normal(size=(VOCAB, D)).astype(np.float32),
        head=(rng.normal(size=(D, VOCAB)) / np.sqrt(D)).astype(np.float32),
        h=rng.normal(size=(B, S, D)).astype(np.float32),
        tokens=rng.integers(0, VOCAB, (B, S)).astype(np.int32),
        labels=labels,
        g_embed=rng.normal(size=(B, S, D)).astype(np.float32))


def _ssm_cfg(arch):
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, compute_dtype="float32")


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ------------------------------------------------------------ the ranks --

def _vocab_checks(mesh):
    """The split embedding and loss on this rank's blocks, their
    gradients, and the one-device gradients' blocks."""
    from repro_torch.launch.sharding import set_mesh
    from repro_torch.models import layers as L

    d = {k: torch.from_numpy(v) for k, v in _data().items()}
    m, r = mesh.shape["model"], mesh.axis_rank("model")
    vl = VOCAB // m
    out = {}

    def run(table, head, h, vocab):
        table = table.clone().requires_grad_(True)
        head = head.clone().requires_grad_(True)
        h = h.clone().requires_grad_(True)
        x = L.embed(d["tokens"], table, torch.float32, vocab)
        loss = L.lm_loss_chunked(h, head, d["labels"], CHUNK, vocab=vocab)
        gt, = torch.autograd.grad((x * d["g_embed"]).sum(), table)
        gh, gw = torch.autograd.grad(loss, (h, head))
        return x.detach(), float(loss), gt, gh, gw

    want = run(d["table"], d["head"], d["h"], None)
    set_mesh(mesh)
    try:
        got = run(d["table"][r * vl:(r + 1) * vl], d["head"][:, r * vl:
                                                             (r + 1) * vl],
                  d["h"], VOCAB)
        out["embed_bf16"] = L.embed(d["tokens"], d["table"][r * vl:(r + 1) * vl],
                                    torch.bfloat16, VOCAB).float().numpy()
    finally:
        set_mesh(None)
    out["embed"], out["loss"] = got[0].numpy(), got[1]
    out["grads"] = {
        "table": (got[2].numpy(), want[2][r * vl:(r + 1) * vl].numpy()),
        "h": (got[3].numpy(), want[3].numpy()),
        "head": (got[4].numpy(), want[4][:, r * vl:(r + 1) * vl].numpy())}
    return out


def _ssm_checks(arch, mesh):
    """Layer 0 of reduced ``arch``'s Mamba stack on this rank's channels
    and on the whole layer (no mesh): outputs and the gradients of the
    input and of every leaf (the whole layer's sliced to this rank's
    blocks)."""
    from repro_torch.launch.sharding import set_mesh
    from repro_torch.models import ssm
    from repro_torch.models.convert import gather_params, shard_params
    from repro_torch.models.transformer import _layer

    cfg = _ssm_cfg(arch)
    block = ssm.mamba1_block if cfg.ssm.version == 1 else ssm.mamba2_block
    whole = build(cfg).init(torch.Generator().manual_seed(3), "cpu",
                            dtype=torch.float32)["mamba"]
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(2, 16, cfg.d_model))
                         .astype(np.float32))
    gy = torch.from_numpy(rng.normal(size=(2, 16, cfg.d_model))
                          .astype(np.float32))

    def run(stack):
        stack = {k: v.clone().requires_grad_(True) for k, v in stack.items()}
        xx = x.clone().requires_grad_(True)
        lp = gather_params(_layer(stack, 0), ("mamba",), cfg, lead=1)
        y, _ = block(xx, lp, cfg)
        grads = torch.autograd.grad((y * gy).sum(), [xx, *stack.values()])
        return y.detach().numpy(), dict(zip(["x", *stack], grads)), lp

    y_one, g_one, _ = run(whole)
    blocks = shard_params({"mamba": whole}, mesh)["mamba"]
    set_mesh(mesh)
    try:
        y, g, lp = run(blocks)
    finally:
        set_mesh(None)
    g_want = dict(shard_params({"mamba": {k: v for k, v in g_one.items()
                                          if k != "x"}}, mesh)["mamba"],
                  x=g_one["x"])
    return dict(
        out=(y, y_one),
        grads={k: (g[k].numpy(), g_want[k].numpy()) for k in g},
        split={k: tuple(v.shape) != tuple(whole[k].shape[1:])
               for k, v in lp.items()})


def _rank_main(rank, world, store, out_dir):
    from repro_torch.launch.mesh import make_train_mesh

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = make_train_mesh((1, world), ("data", "model"), devices="cpu")
        out = {"vocab": _vocab_checks(mesh)}
        for arch in SSM_ARCHS:
            out[arch] = _ssm_checks(arch, mesh)
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------- the test process --

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("vocab_parallel")
    dirs = {w: root / f"world{w}" for w in WORLDS}
    ctxs = {}
    for w, d in dirs.items():
        d.mkdir()
        ctxs[w] = mp.spawn(_rank_main, nprocs=w, join=False,
                           args=(w, str(d / "store"), str(d)))
    out = {}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    for w, ctx in ctxs.items():
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the world-{w} group ran past "
                            f"{SPAWN_TIMEOUT_S} s")
        out[w] = [torch.load(dirs[w] / f"rank{r}.pt", weights_only=False)
                  for r in range(w)]
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's lookup (fp32, bf16) and loss on the same numpy
    inputs."""
    from repro.models import layers as RL

    d = _data()
    return dict(
        embed=np.asarray(RL.embed(jnp.asarray(d["tokens"]),
                                  jnp.asarray(d["table"]), jnp.float32)),
        embed_bf16=np.asarray(RL.embed(
            jnp.asarray(d["tokens"]), jnp.asarray(d["table"]),
            jnp.bfloat16).astype(jnp.float32)),
        loss=float(RL.lm_loss_chunked(jnp.asarray(d["h"]),
                                      jnp.asarray(d["head"]),
                                      jnp.asarray(d["labels"]), CHUNK)))


@pytest.mark.parametrize("world", WORLDS)
def test_vocab_parallel_embed_equals_reference_bit_for_bit(runs, reference,
                                                           world):
    for r in runs[world]:
        np.testing.assert_array_equal(r["vocab"]["embed"], reference["embed"])
        np.testing.assert_array_equal(r["vocab"]["embed_bf16"],
                                      reference["embed_bf16"])


@pytest.mark.parametrize("world", WORLDS)
def test_vocab_parallel_loss_matches_reference(runs, reference, world):
    want = reference["loss"]
    for r in runs[world]:
        assert abs(r["vocab"]["loss"] - want) <= LOSS_RTOL * abs(want), (
            r["vocab"]["loss"], want)
    # every rank holds the same loss
    assert len({r["vocab"]["loss"] for r in runs[world]}) == 1


@pytest.mark.parametrize("name", ("h", "table", "head"))
@pytest.mark.parametrize("world", WORLDS)
def test_vocab_parallel_gradients_match_one_device(runs, world, name):
    for r in runs[world]:
        got, want = r["vocab"]["grads"][name]
        assert got.shape == want.shape
        assert _rel(got, want) <= GRAD_TOL, name


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_ssm_block_on_model_axis_matches_one_device(runs, world, arch):
    for r in runs[world]:
        rep = r[arch]
        # the layer ran on its blocks: every channel leaf split
        assert all(rep["split"].values()), rep["split"]
        y, y_one = rep["out"]
        np.testing.assert_allclose(y, y_one, rtol=0, atol=BLOCK_TOL)
        for k, (got, want) in rep["grads"].items():
            assert got.shape == want.shape, k
            assert _rel(got, want) <= BLOCK_TOL, (k, _rel(got, want))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_gather_params_keeps_model_blocks_of_split_layers(arch):
    """Every leaf whose layer computes on its model-axis block is gathered
    over the data axes only: ``WIRE`` logs one all_gather a dim the plan
    splits over data, each of the block's bytes, and none over the model
    axis."""
    from repro_torch.core.collectives import WIRE
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.launch.sharding import set_mesh
    from repro_torch.launch.steps import init_train_state
    from repro_torch.models.convert import (_walk, computes_split,
                                            gather_params, param_shapes,
                                            shard_dim)

    cfg = get_config(arch).reduced()
    bundle = build(cfg)
    checked = set()
    for shape, axes in (((2, 2, 2), ("pod", "data", "model")),
                        ((1, 4), ("data", "model"))):
        mesh = make_abstract_mesh(shape, axes)
        params = init_train_state(bundle, None, "meta", mesh=mesh)["params"]
        set_mesh(mesh)
        try:
            for path, leaf in _walk(params):
                plan = shard_dim(path, cfg, mesh)
                if not (computes_split(path, cfg, mesh) and any(
                        "model" in (a or ()) for a in plan)):
                    continue
                WIRE.reset()
                got = gather_params(leaf, path, cfg)
                want, n = [], leaf.numel() * leaf.element_size()
                for dim, a in enumerate(plan):
                    dp = [x for x in a or ()
                          if x != "model" and mesh.shape[x] > 1]
                    if dp:
                        want.append(("all_gather", n))
                        n *= int(np.prod([mesh.shape[x] for x in dp]))
                assert [(op, b) for op, _, b in WIRE.entries] == want, path
                # whole but for the model axis's split
                assert tuple(got.shape) == tuple(
                    n // mesh.shape["model"] if "model" in (a or ()) else n
                    for n, a in zip(param_shapes(cfg)[path], plan)), path
                checked.add(path[-1])
        finally:
            set_mesh(None)
    assert {"embed", "lm_head"} <= checked
    if cfg.family in ("ssm", "hybrid"):
        assert {"in_proj", "conv_w", "out_proj", "a_log"} <= checked
