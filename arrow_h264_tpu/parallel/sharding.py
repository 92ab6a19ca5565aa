"""Multi-stream / multi-device decode sharding (SURVEY.md §2 parallelism).

The decode dataflow is embarrassingly parallel across streams: the stream
batch shards across a 1-D `stream` mesh via shard_map, and inside each
shard the per-device streams run through the vmapped batch pipeline.  No
collectives exist in the decode path — the only transport is the
host->device MB-tensor upload.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..models.pipeline import decode_frames_batch_fn


def make_stream_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), ("stream",))


def sharded_decode_fn(mesh: Mesh, mb_w: int, mb_h: int, ws4, ws8,
                      cqp_off=(0, 0), n_streams: int | None = None,
                      inter: bool = False, bypass: bool = False,
                      field: bool = False):
    """jit the batched decode (abi_b, dpb_y_b, dpb_c_b) -> (y, cb, cr)
    with the stream batch sharded over the mesh.

    n_streams must be a multiple of the mesh size (default: one per
    device)."""
    n_dev = mesh.devices.size
    if n_streams is None:
        n_streams = n_dev
    assert n_streams % n_dev == 0, (n_streams, n_dev)

    def decode_batch(abi_b, dpb_y_b, dpb_c_b):
        return decode_frames_batch_fn(
            abi_b, dpb_y_b, dpb_c_b, mb_w=mb_w, mb_h=mb_h,
            ws4=jnp.asarray(ws4), ws8=jnp.asarray(ws8), cqp_off=cqp_off,
            inter=inter, bypass=bypass, field=field)

    spec = P("stream")
    # check_vma=False: the intra and deblock wavefront scans start their
    # carries from constants (zero planes), which the varying-axes check
    # rejects against the per-stream outputs; every value here varies
    # over "stream" anyway (decode is data-parallel only)
    mapped = jax.shard_map(decode_batch, mesh=mesh,
                           in_specs=(spec, spec, spec),
                           out_specs=spec, check_vma=False)
    return jax.jit(mapped)


def sharded_store_fn(mesh: Mesh, n_streams: int | None = None):
    """jit the batched reference store (per-stream DPB slot write) with the
    stream batch sharded over the mesh.  Streams that must not store pass
    the trash slot (n_slots - 1 of the over-allocated batch DPB)."""
    from ..models.pipeline import store_ref_fn
    n_dev = mesh.devices.size
    if n_streams is None:
        n_streams = n_dev
    assert n_streams % n_dev == 0, (n_streams, n_dev)

    def store_batch(dpb_y_b, dpb_c_b, slot_b, y_b, cb_b, cr_b):
        # store_ref_fn is pure XLA (halfpel + pack + slot write): vmap
        # instead of an unrolled per-stream loop (one traced body)
        return jax.vmap(store_ref_fn)(dpb_y_b, dpb_c_b, slot_b,
                                      y_b, cb_b, cr_b)

    spec = P("stream")
    mapped = jax.shard_map(store_batch, mesh=mesh, in_specs=(spec,) * 6,
                           out_specs=(spec, spec))
    return jax.jit(mapped, donate_argnums=(0, 1))
