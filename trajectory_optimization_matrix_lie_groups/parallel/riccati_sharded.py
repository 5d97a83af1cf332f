"""Time-axis-sharded parallel-prefix Riccati backward pass.

The single-chip associative sweep (`solvers/riccati.parallel_backward`)
already gives O(log N) depth on one device; this module shards the SAME
value-element suffix scan across a device mesh over the *time* axis — the
SURVEY §2.6/§5.7 "optionally sharded for very long horizons" box (the
reference's horizon loops are serial Python, `traopt_controller.py:1637`;
its N reaches 1400, `main_SE3ddp_tracking_exact_al_ms.py:50`).

Two-level parallel prefix (Blelloch across the mesh):

  1. each device runs the local associative suffix scan over its
     contiguous time block (`lax.associative_scan` on the shard);
  2. the per-block aggregate elements (one 5-tensor tuple of <=n x n
     matrices per device — KBs) are `all_gather`ed over the mesh axis and
     suffix-exclusive-combined serially (mesh-size static, ~8 steps);
  3. each device folds the aggregate of all *later* blocks into its local
     suffixes with one batched `combine`.

Communication is a single tiny all-gather on the ICI — the per-stage
arrays never move.  Horizons that don't divide the mesh are padded with
the combine's identity element (A=I, b=0, C=0, eta=0, J=0; identity on
the *later* side by the combine algebra), appended on the late-time end
where suffix scans ignore them.

`sharded_parallel_backward` matches `riccati.parallel_backward`
bit-for-bit-modulo-roundoff (tests/test_riccati_sharded.py pins this on
the 8-device virtual mesh).
"""

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from trajectory_optimization_matrix_lie_groups.solvers.riccati import (
    _all_quu_pd,
    _bmv,
    _solve,
    build_elements,
    combine,
)


def default_time_mesh(axis: str = "time", n: int = None) -> Mesh:
    """A 1-d mesh over all (or the first ``n``) local devices for the
    time-sharded sweep."""
    import numpy as np

    devs = jax.devices()
    if n is not None:
        devs = devs[:n]
    return Mesh(np.asarray(devs), (axis,))


def _identity_element(n, dtype):
    I = jnp.eye(n, dtype=dtype)
    z = jnp.zeros((n, n), dtype=dtype)
    return (I, jnp.zeros((n,), dtype=dtype), z, jnp.zeros((n,), dtype=dtype),
            z)


def _pad_elements(elems, n_pad):
    """Append n_pad identity elements on the late-time end."""
    if n_pad == 0:
        return elems
    n = elems[0].shape[-1]
    ident = _identity_element(n, elems[0].dtype)
    return tuple(
        jnp.concatenate([e, jnp.broadcast_to(i, (n_pad,) + i.shape)], axis=0)
        for e, i in zip(elems, ident))


def sharded_suffix_scan(elems, mesh: Mesh, axis: str = "time"):
    """Suffix-combine scan of value elements, time-sharded over ``mesh``.

    ``elems``: the (M, ...) element tuple from `build_elements` (M = N+1),
    already padded so M divides the mesh size.  Returns the (M, ...) suffix
    elements: out[i] = e_i ∘ e_{i+1} ∘ ... ∘ e_{M-1}.
    """
    n_dev = mesh.devices.size

    def block(*es):
        # 1. local suffix scan over this device's time block
        local = lax.associative_scan(lambda a, b: combine(b, a), es,
                                     reverse=True, axis=0)
        # 2. block aggregate = suffix at the block head; gather all blocks
        agg = tuple(l[0] for l in local)
        gathered = tuple(lax.all_gather(a, axis) for a in agg)  # (n_dev,...)
        # suffix-EXCLUSIVE aggregates: S[k] = A_{k+1} ∘ ... ∘ A_{n-1}
        n = es[0].shape[-1]
        S = _identity_element(n, es[0].dtype)
        S_stack = [S]
        for k in range(n_dev - 1, 0, -1):
            A_k = tuple(g[k] for g in gathered)
            S = combine(A_k, S)
            S_stack.append(S)
        S_stack = S_stack[::-1]  # S_stack[k] for block k
        S_all = tuple(jnp.stack([s[i] for s in S_stack])
                      for i in range(5))
        idx = lax.axis_index(axis)
        S_mine = tuple(lax.dynamic_index_in_dim(s, idx, keepdims=False)
                       for s in S_all)
        # 3. fold the later-blocks aggregate into every local suffix
        S_b = tuple(jnp.broadcast_to(s, (es[0].shape[0],) + s.shape)
                    for s in S_mine)
        return combine(local, S_b)

    kw = dict(mesh=mesh, in_specs=(P(axis),) * 5, out_specs=P(axis))
    try:  # check_rep renamed check_vma in jax 0.8
        sm = shard_map(block, check_vma=False, **kw)
    except TypeError:
        sm = shard_map(block, check_rep=False, **kw)
    return sm(*elems)


def sharded_parallel_backward(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, mesh: Mesh,
                              axis: str = "time", mu=0.0):
    """Drop-in time-sharded twin of `riccati.parallel_backward`.

    Returns (k, K, Vx_next, Vxx_next) with identical semantics; the
    element scan runs sharded over ``mesh[axis]``, the per-stage gain
    solves stay stage-batched (auto-partitioned).
    """
    elems = build_elements(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, mu)
    M = elems[0].shape[0]
    n_dev = mesh.devices.size
    n_pad = (-M) % n_dev
    suffix = sharded_suffix_scan(_pad_elements(elems, n_pad), mesh, axis)
    suffix = tuple(s[:M] for s in suffix)
    _, _, _, eta_s, J_s = suffix
    Vx = -eta_s
    Vxx = J_s
    Vx_next = Vx[1:]
    Vxx_next = Vxx[1:]

    fuT = jnp.swapaxes(Fu, -1, -2)
    n = Fx.shape[-1]
    eye = jnp.eye(n, dtype=Fx.dtype)
    Vreg = Vxx_next + mu * eye
    Vmod = Vx_next + _bmv(Vxx_next, d)
    Qu = Lu + _bmv(fuT, Vmod)
    Qux = Lux + fuT @ Vreg @ Fx
    Quu = Luu + fuT @ Vreg @ Fu
    k = -_solve(Quu, Qu[..., None])[..., 0]
    K = -_solve(Quu, Qux)
    return k, K, Vx_next, Vxx_next


def sharded_backward_adaptive(Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu,
                              mu, delta, mesh: Mesh, axis: str = "time",
                              mu_min=1e-6, mu_max=1e10, delta_0=2.0):
    """Time-sharded twin of `riccati.parallel_backward_adaptive`.

    Same whole-sweep batched LM retry (reference mu/delta schedule) and
    the same finite-output guarantee on the mu_max-exceeded path, with
    the associative sweep running time-sharded over ``mesh``.  Returns
    the 7-tuple the production solvers expect, so
    `backward='associative_sharded'` drops into `LieILQR`.
    """
    def attempt(m):
        k, K, Vx_n, Vxx_n = sharded_parallel_backward(
            Fx, Fu, d, Lx, Lu, Lxx, Lux, Luu, mesh=mesh, axis=axis, mu=m)
        ok = (_all_quu_pd(Fx, Fu, Luu, Vxx_n, m)
              & jnp.all(jnp.isfinite(k)) & jnp.all(jnp.isfinite(K))
              & jnp.all(jnp.isfinite(Vxx_n)) & jnp.all(jnp.isfinite(Vx_n)))
        return k, K, Vx_n, Vxx_n, ok

    k0, K0, Vx0, Vxx0, ok0 = attempt(mu)

    def cond(c):
        return jnp.logical_not(c[0])

    def body(c):
        _, mu_q, _, dlt, exc, _ = c
        dlt_inc = jnp.maximum(1.0, dlt) * delta_0
        mu_inc = jnp.maximum(mu_min, mu_q * dlt_inc)
        hit_max = mu_inc >= mu_max
        k, K, Vx_n, Vxx_n, ok = attempt(mu_inc)
        done = ok | hit_max
        return (done, mu_inc, mu_inc, dlt_inc,
                exc | (hit_max & jnp.logical_not(ok)),
                (k, K, Vx_n, Vxx_n))

    state = (ok0, jnp.asarray(mu, Fx.dtype), jnp.asarray(mu, Fx.dtype),
             jnp.asarray(delta, Fx.dtype), jnp.asarray(False),
             (k0, K0, Vx0, Vxx0))
    done, mu_q, _, dlt, exceeded, (k, K, Vx_n, Vxx_n) = lax.while_loop(
        cond, body, state)
    dlt_dec = jnp.minimum(1.0, dlt) / delta_0
    mu_dec = mu_q * dlt_dec
    mu_dec = jnp.where(mu_dec <= mu_min, 0.0, mu_dec)
    mu_out = jnp.where(exceeded, mu_q, mu_dec)
    delta_out = jnp.where(exceeded, dlt, dlt_dec)

    def _fin(x, fb):
        return jnp.where(jnp.isfinite(x), x, fb)

    k = _fin(k, jnp.zeros_like(k))
    K = _fin(K, jnp.zeros_like(K))
    Vx_n = _fin(Vx_n, Lx[1:])
    Vxx_n = _fin(Vxx_n, Lxx[1:])
    return k, K, Vx_n, Vxx_n, mu_out, delta_out, exceeded
