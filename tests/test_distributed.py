"""Multi-host (multi-process) execution of the distributed layer.

SURVEY §5.8 names jax.distributed as this framework's multi-host
communication backend. This test actually executes
``parallel.mesh.initialize_distributed``: it spawns TWO separate Python
processes on localhost (Gloo CPU collectives, coordinator on 127.0.0.1),
each contributing 2 virtual CPU devices to a global 4-device mesh, runs the
REAL sharded statistics program (``make_sharded_embed_stats`` — shard_map +
psum over the 'data' axis) on process-local shards, and asserts the
psum-reduced (mu, sigma) equal the single-process NumPy result on every
process."""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

_CHILD = textwrap.dedent(
    """
    import sys
    pid = int(sys.argv[1]); port = sys.argv[2]

    import jax
    # Per-process platform pinning must happen BEFORE backend init.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)

    sys.path.insert(0, {repo!r})
    from frechet_audio_distance_exported_tpu.parallel import mesh as mesh_mod

    mesh_mod.initialize_distributed(f"127.0.0.1:{{port}}", 2, pid)

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    assert jax.process_count() == 2, jax.process_count()
    devs = jax.devices()
    assert len(devs) == 4, devs
    m = mesh_mod.data_mesh(devs)

    # The full row set is deterministic on both processes; each process
    # hosts only its local shard of the global array.
    rows = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32)
    sh = NamedSharding(m, P(mesh_mod.DATA_AXIS))
    garr = jax.make_array_from_process_local_data(
        sh, rows[pid * 4:(pid + 1) * 4], rows.shape)
    gmask = jax.make_array_from_process_local_data(
        sh, np.ones(4, np.float32), (8,))

    from frechet_audio_distance_exported_tpu.ops import stats as stats_ops
    from frechet_audio_distance_exported_tpu.parallel import embed

    fn = embed.make_sharded_embed_stats(m, lambda params, r: r)
    state = fn({{}}, garr, gmask)
    mu, sigma = stats_ops.finalize_stats(state)
    mu = np.asarray(jax.device_get(mu))
    sigma = np.asarray(jax.device_get(sigma))
    np.testing.assert_allclose(mu, rows.mean(0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        sigma, np.cov(rows, rowvar=False), rtol=1e-4, atol=1e-5)
    print(f"DIST-OK {{pid}}", flush=True)
    """
)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_stats(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "child.py"
    script.write_text(_CHILD.format(repo=repo))
    port = _free_port()

    env = dict(os.environ)
    # The children pin their own platform/device count; scrub the test
    # harness's forced-CPU knobs so they don't fight the explicit config.
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"

    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=repo,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed children timed out:\n" + "\n".join(outs))

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert f"DIST-OK {pid}" in out, out
