"""Worker process for the two-process jax.distributed CPU test.

Launched by tests/test_distributed.py as
``python tests/distributed_worker.py <process_id> <num_processes> <port>``.
Each process contributes 4 virtual CPU devices to an 8-device global
``sites`` mesh (the DCN-over-localhost analogue of a 2-host pod slice),
runs the sharded fused PLF, and prints the psum'd scaler increment plus a
global checksum for the parent to cross-check.
"""

import os
import sys


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")

    import numpy as np
    import jax.numpy as jnp

    from plf_tpu.parallel.distributed import (global_site_mesh,
                                              initialize_distributed,
                                              process_summary,
                                              validate_site_workload)
    from plf_tpu.parallel.sharding import ShardedPLF

    ok = initialize_distributed(coordinator_address=f"localhost:{port}",
                                num_processes=nproc, process_id=pid)
    assert ok, "initialize_distributed returned False"
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == 4 * nproc
    print(process_summary(), file=sys.stderr, flush=True)

    mesh = global_site_mesh()
    n = 2000
    validate_site_workload(mesh, n_sites=n, block_sites=128)

    rng = np.random.default_rng(7)
    e = 16
    x1 = (rng.random((n, e)) * 0.99 + 0.01).astype(np.float32)
    x2 = (rng.random((n, e)) * 0.99 + 0.01).astype(np.float32)
    x1[1::5] *= np.float32(1e-8)
    x2[1::5] *= np.float32(1e-8)
    left = rng.random((4, 4, 4)).astype(np.float32)
    right = rng.random((4, 4, 4)).astype(np.float32)
    ev = rng.random((4, 4)).astype(np.float32)
    wgt = rng.integers(1, 4, size=n).astype(np.int32)

    sp = ShardedPLF(mesh=mesh, block_sites=128)
    x1d = sp.prepare(x1, n)
    x2d = sp.prepare(x2, n)
    lc, rc, ec = sp.constants(left, right, ev)
    wd = sp.prepare_weights(wgt, n)
    x3, scaler, inc = sp(x1d, x2d, lc, rc, ec, wd, n)
    chk = float(jax.jit(jnp.sum)(x3))
    print(f"RESULT inc={int(inc)} chk={chk:.6e}", flush=True)


if __name__ == "__main__":
    main()
