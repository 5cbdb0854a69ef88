"""Multi-host initialisation and mesh construction.

The reference is single-card with no inter-node distribution — its README
names multi-instance site-sharding as the roadmap (README.md:201-205).
The scale-out story is:

* one host: shard the site axis over its cards (parallel/sharding.py —
  the mesh spans all local devices, which NVLink joins all to all);
* several hosts: ``jax.distributed.initialize`` + a global mesh whose
  site axis crosses hosts.  The PLF is pointwise over sites, so the only
  cross-host traffic is the scalar psum of weighted scaler counts /
  log-likelihood partials — weak scaling is communication-trivial.

Includes fail-fast mesh/shape validation (the reference has no failure
detection at all, SURVEY.md §5; multi-host jobs need at least this).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["initialize_distributed", "global_site_mesh",
           "validate_site_workload", "process_summary"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Initialise jax.distributed for a multi-host run.

    On single-host (or when already initialised) this is a no-op
    returning False.  Where no cluster manager announces the job, pass
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` explicitly.
    """
    if num_processes is not None and num_processes <= 1:
        return False
    # Do NOT probe jax.process_count() here: it initialises the backend,
    # after which jax.distributed.initialize() refuses to run.
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
        return True
    except RuntimeError as e:
        if "already" in str(e).lower():
            return True   # initialised earlier in this process
        return False      # backend already started single-process
    except ValueError:
        # single-host / auto-detection unavailable: stay local
        return False


def global_site_mesh(axis: str = "sites",
                     devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over ALL global devices (all hosts), site-sharded.

    With N hosts x D local devices the mesh is (N*D,); JAX places each
    host's shard on its local devices, so CLV site shards never cross
    hosts — only the psum scalars do.
    """
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devs), (axis,))


def validate_site_workload(mesh: Mesh, n_sites: int, block_sites: int,
                           axis: str = "sites") -> None:
    """Fail fast on inconsistent mesh/workload shapes (mesh mismatch is
    the one failure mode a multi-host PLF job must catch up front)."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no '{axis}' axis: {dict(mesh.shape)}")
    ndev = mesh.shape[axis]
    if n_sites <= 0:
        raise ValueError(f"n_sites must be positive, got {n_sites}")
    if block_sites % 128:
        raise ValueError(
            f"block_sites {block_sites} not a multiple of 128 (the site "
            "padding unit, config.PLFConfig)")
    unit = ndev * block_sites
    sites_per_dev = -(-n_sites // ndev)
    if sites_per_dev < 128:
        raise ValueError(
            f"{n_sites} sites over {ndev} devices leaves {sites_per_dev} "
            "sites/device (< 128); use fewer devices")
    # All processes must agree on the device count they contribute.
    local = len([d for d in mesh.devices.flat
                 if d.process_index == jax.process_index()])
    if jax.process_count() > 1 and local == 0:
        raise ValueError(
            f"process {jax.process_index()} contributes no devices to the "
            "mesh — mesh/process topology mismatch")


def process_summary() -> str:
    """One-line cluster summary for logs."""
    return (f"process {jax.process_index()}/{jax.process_count()} | "
            f"{jax.local_device_count()} local / "
            f"{jax.device_count()} global devices | "
            f"backend={jax.default_backend()}")
