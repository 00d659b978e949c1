"""The multi-device path of batrack_tpu_torch (parallel/) at world 2 against
batrack_tpu's 2-device CPU mesh.

The port runs one process per rank: each test spawns two fresh processes
(the spawn start method) that join a gloo group through a file in the
test's tmp_path, one or two threads each, and save their results; the test
process runs the JAX side and compares. The ranks import this module, so it
imports no JAX at the top: the JAX package is imported inside the tests.

Tolerances: sharded attention 1e-5 (float32, the plain version of K2 with
a kv= source against the Pallas kernel in interpret mode); sharded
correlation 2e-2 against the Pallas kernel (both read the maps in bf16, the
budget tests/test_parallel.py states) and exact against the unsharded port.
The patch-sharded backend update is held in test_torch_sharded_ba.py.
"""

import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from batrack_tpu_torch.ops import corr
from batrack_tpu_torch.ops.corr_kernel import corr_sample, pack_pyramid
from batrack_tpu_torch.parallel import (
    Mesh,
    corr_sample_pyramid_sharded,
    fused_qkv_attention_sharded,
    gather_rows,
    get_mesh,
    shard_rows,
)

WORLD = 2
N_TRACKS = 21  # odd: the pad path runs


RANK_TIMEOUT_S = 240  # a rank stuck in a collective fails the test, not the run


def _rank_entry(rank, world, tmp, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        out = fn(get_mesh(world, device="cpu"), *args)
        np.savez(f"{tmp}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, tmp_path, *args, world=WORLD):
    """fn(mesh, *args) -> dict of arrays, on `world` gloo ranks in spawned
    processes; returns each rank's dict. Raises when a rank fails, and
    stops the ranks and fails after RANK_TIMEOUT_S."""
    ctx = mp.start_processes(_rank_entry, args=(world, str(tmp_path), fn, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks did not finish within {RANK_TIMEOUT_S} s")
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


# ---------------------------------------------------------------- kernels
def _kernel_inputs():
    rng = np.random.default_rng(5)
    B, heads, d = 2, 2, 48
    att = dict(qkv=rng.normal(size=(B, N_TRACKS, 3 * heads * d)).astype(np.float32),
               mask=rng.uniform(size=N_TRACKS) > 0.3, heads=heads, scale=d ** -0.5)
    S, C, H, W = 2, 128, 16, 24
    cor = dict(fm=rng.normal(size=(S, C, H, W)).astype(np.float32),
               targets=rng.normal(size=(N_TRACKS, S, C)).astype(np.float32),
               coords=np.stack([rng.uniform(-8, W + 8, (S, N_TRACKS)),
                                rng.uniform(-8, H + 8, (S, N_TRACKS))], -1).astype(np.float32))
    return att, cor


def _sharded_kernels(mesh, att, cor):
    qkv = torch.from_numpy(att["qkv"])
    out = {}
    for name, mask in (("masked", torch.from_numpy(att["mask"])),
                       ("unmasked", torch.ones(N_TRACKS, dtype=torch.bool))):
        loc = fused_qkv_attention_sharded(shard_rows(qkv, mesh, 1), att["heads"], att["scale"],
                                          mesh, shard_rows(mask, mesh))
        out[f"attn_{name}"] = gather_rows(loc, mesh, N_TRACKS, dim=1).numpy()
    pyr = pack_pyramid(corr.build_pyramid(torch.from_numpy(cor["fm"]), 3))
    loc = corr_sample_pyramid_sharded(pyr, torch.from_numpy(cor["targets"]),
                                      torch.from_numpy(cor["coords"]), 3, mesh)
    out["corr_local_rows"] = np.asarray(loc.shape[0])
    out["corr"] = gather_rows(loc, mesh, N_TRACKS).numpy()
    return out


@pytest.fixture(scope="module")
def kernel_runs(tmp_path_factory):
    att, cor = _kernel_inputs()
    return att, cor, run_ranks(_sharded_kernels, tmp_path_factory.mktemp("pg"), att, cor)


@pytest.mark.parametrize("masked", [True, False])
def test_sharded_attention_matches_jax_mesh(kernel_runs, masked):
    """Local queries against the gathered key/value lanes, padded keys
    masked: JAX's shard_map'd packed-qkv kernel (interpret mode)."""
    import jax.numpy as jnp

    from batrack_tpu.parallel import get_mesh as jget_mesh
    from batrack_tpu.parallel.shard_kernels import fused_qkv_attention_sharded as jsharded

    att, _, ranks = kernel_runs
    mask = jnp.asarray(att["mask"]) if masked else None
    ref = jsharded(jnp.asarray(att["qkv"]), att["heads"], att["scale"],
                   jget_mesh(WORLD, ("track",)), key_mask=mask, interpret=True)
    key = "attn_masked" if masked else "attn_unmasked"
    for r in ranks:
        np.testing.assert_allclose(r[key], np.asarray(ref), atol=1e-5, rtol=0)


def test_sharded_corr_matches_jax_mesh(kernel_runs):
    import jax.numpy as jnp

    from batrack_tpu.ops import corr as jcorr
    from batrack_tpu.parallel import get_mesh as jget_mesh
    from batrack_tpu.parallel.shard_kernels import corr_sample_pyramid_sharded as jsharded

    _, cor, ranks = kernel_runs
    jpyr = jcorr.build_pyramid(jnp.asarray(cor["fm"]), 3)
    ref = jsharded(jpyr, jnp.asarray(cor["targets"]), jnp.asarray(cor["coords"]), 3,
                   jget_mesh(WORLD, ("track",)), interpret=True)
    pyr = pack_pyramid(corr.build_pyramid(torch.from_numpy(cor["fm"]), 3))
    targets, coords = torch.from_numpy(cor["targets"]), torch.from_numpy(cor["coords"])
    single = corr_sample(pyr, targets, coords, 3)
    for r in ranks:
        assert int(r["corr_local_rows"]) == -(-N_TRACKS // WORLD)
        np.testing.assert_allclose(r["corr"], np.asarray(ref), atol=2e-2, rtol=0)
        np.testing.assert_array_equal(r["corr"], single.numpy())


# ---------------------------------------------------------------- layout
@pytest.mark.parametrize("n,world", [(21, 2), (21, 4), (8, 4), (3, 4)])
def test_shard_rows_pads_and_gather_inverts(n, world):
    """shard_rows hands rank r rows [r*n_loc, (r+1)*n_loc) of the axis padded
    with zeros (False) to a multiple of the world size; concatenating the
    ranks' rows and cutting to n gives the axis back (what gather_rows does
    after its all-gather)."""
    x = torch.arange(2 * n * 3, dtype=torch.float32).reshape(2, n, 3)
    mask = torch.arange(n) % 3 != 0
    meshes = [Mesh(None, r, world, torch.device("cpu")) for r in range(world)]
    parts = [shard_rows(x, m, 1) for m in meshes]
    n_loc = -(-n // world)
    assert all(p.shape == (2, n_loc, 3) for p in parts)
    assert torch.equal(torch.cat(parts, 1)[:, :n], x)
    assert not torch.cat(parts, 1)[:, n:].any()
    mparts = [shard_rows(mask, m) for m in meshes]
    assert all(p.dtype == torch.bool for p in mparts)
    assert torch.equal(torch.cat(mparts)[:n], mask) and not torch.cat(mparts)[n:].any()


TORCHRUN_SCRIPT = """
import os
import torch
import torch.distributed as dist
from batrack_tpu_torch.parallel import (gather_rows, get_host_chip_mesh, get_mesh,
                                        init_distributed, shard_rows)

torch.set_num_threads(1)
init_distributed(device="cpu")
mesh = get_mesh(int(os.environ["WORLD_SIZE"]), device="cpu")
assert get_host_chip_mesh(device="cpu") == mesh  # a flat group
x = torch.arange(21.0)
assert torch.equal(gather_rows(shard_rows(x, mesh), mesh, 21), x)
print(f"rank {mesh.rank} of {mesh.size} on {dist.get_backend()}", flush=True)
dist.destroy_process_group()
"""


def test_init_distributed_joins_the_torchrun_group(tmp_path):
    """torchrun (standalone, one host, a free localhost port) starts two
    processes; init_distributed() joins the group it describes in the
    environment and get_mesh(2) sees both ranks."""
    script = tmp_path / "ranks.py"
    script.write_text(TORCHRUN_SCRIPT)
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2", str(script)], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    for r in range(2):
        assert f"rank {r} of 2 on gloo" in out.stdout
