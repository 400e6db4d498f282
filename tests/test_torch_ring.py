"""Ring PASA over a process group (``repro_torch.core.ring``) against the
reference.

A gloo group of 4 ranks (``torch.multiprocessing`` with a ``file://``
store under the test's temporary directory) runs ``make_ring_attention``
on the reference's own inputs of tests/test_launch.py::
test_ring_pasa_on_mesh (q + 1, k + 2, (1, 2, 128, 32), beta 0.984497,
block_kv 32):

  * at the float64 policy, within 1e-12 relative RMSE of the reference's
    float64 ``naive_attention`` (its bar), causal or not;
  * at the fp16 policy, in the RMSE class of the reference's one-device
    ``blocked_attention`` at fp16: at most twice its RMSE against the same
    float64 gold.

With no process group the ring is one rank and folds every block itself.

The spawned ranks import this module and need torch alone, so the
reference is imported inside the functions of the test process.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import F64, FP16, make_ring_attention
from repro_torch.core import ring_pasa_attention
from repro_torch.launch.mesh import make_mesh

torch.set_num_threads(1)

BETA = 0.984497
BLOCK = 32
WORLD = 4
SPAWN_TIMEOUT_S = 180
CASES = (("f64", False), ("f64", True), ("fp16", False), ("fp16", True))


def _inputs():
    import jax
    import jax.numpy as jnp

    q = jax.random.normal(jax.random.PRNGKey(0), (1, 2, 128, 32),
                          jnp.float32) + 1.0
    k = jax.random.normal(jax.random.PRNGKey(1), (1, 2, 128, 32),
                          jnp.float32) + 2.0
    v = jax.random.normal(jax.random.PRNGKey(2), (1, 2, 128, 32),
                          jnp.float32)
    return [np.array(x) for x in (q, k, v)]


def _rank_main(rank, store, out_dir, qkv):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_mesh((WORLD,), ("model",), devices="cpu")
        q, k, v = (torch.from_numpy(x) for x in qkv)
        out = {}
        for pol, causal in CASES:
            fn = make_ring_attention(
                mesh, "model", beta=BETA, policy=F64 if pol == "f64" else FP16,
                block_kv=BLOCK, causal=causal)
            out[(pol, causal)] = fn(q, k, v)
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    qkv = _inputs()
    ctx = mp.spawn(_rank_main, args=(str(tmp / "store"), str(tmp), qkv),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ring group ran past {SPAWN_TIMEOUT_S} s")
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return qkv, got


def _ref():
    """The reference's jnp, attention functions and policies."""
    import jax.numpy as jnp

    from repro.core import F64 as REF_F64
    from repro.core import FP16 as REF_FP16
    from repro.core import blocked_attention, naive_attention
    from repro.core.numerics import rmse

    return jnp, naive_attention, blocked_attention, rmse, REF_F64, REF_FP16


def _gold(qkv, causal):
    jnp, naive, *_ = _ref()
    return naive(*(jnp.asarray(x) for x in qkv), causal=causal,
                 dtype=jnp.float64)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_f64_is_exact_attention(ring, causal):
    ref_rmse = _ref()[3]
    qkv, got = ring
    gold = _gold(qkv, causal)
    for rank, res in enumerate(got):
        out = res[("f64", causal)]
        assert out.shape == (1, 2, 128, 32) and out.dtype == torch.float64
        assert ref_rmse(out.numpy(), gold) < 1e-12, rank


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_fp16_in_the_one_device_rmse_class(ring, causal):
    jnp, _, ref_blocked, ref_rmse, _, REF_FP16 = _ref()
    qkv, got = ring
    gold = _gold(qkv, causal)
    one = ref_blocked(*(jnp.asarray(x) for x in qkv), beta=BETA,
                      policy=REF_FP16, block_kv=BLOCK, causal=causal)
    bar = 2.0 * ref_rmse(one, gold)
    for res in got:
        out = res[("fp16", causal)].float().numpy()
        assert np.isfinite(out).all()
        assert ref_rmse(out, gold) < bar
    # every rank returns the same whole output
    for res in got[1:]:
        assert torch.equal(res[("fp16", causal)], got[0][("fp16", causal)])


def test_one_rank_ring_without_a_group():
    """No process group: one rank folds every block, causal rows and the
    kv_len columns masked (the ragged-tail convention)."""
    jnp, ref_naive, ref_blocked, ref_rmse, REF_F64, _ = _ref()
    qkv = _inputs()
    q, k, v = (torch.from_numpy(x) for x in qkv)
    out = ring_pasa_attention(q, k, v, beta=BETA, policy=F64,
                              block_kv=BLOCK, causal=True)
    assert ref_rmse(out.numpy(), _gold(qkv, True)) < 1e-12
    live = 100
    ks, vs = k.clone(), v.clone()
    ks[:, :, live:] = 0.0
    vs[:, :, live:] = 0.0
    out = ring_pasa_attention(
        q, ks, vs, beta=BETA, policy=F64, block_kv=BLOCK,
        kv_len=torch.tensor(live).reshape(1, 1, 1, 1))
    gold = ref_naive(*(jnp.asarray(x[:, :, :live] if i else x)
                       for i, x in enumerate(qkv)), dtype=jnp.float64)
    assert ref_rmse(out.numpy(), gold) < 1e-12
    ref64 = ref_blocked(*(jnp.asarray(x) for x in qkv), beta=BETA,
                        policy=REF_F64, block_kv=BLOCK)
    got = ring_pasa_attention(q, k, v, beta=BETA, policy=F64, block_kv=BLOCK)
    assert ref_rmse(got.numpy(), ref64) < 1e-12
