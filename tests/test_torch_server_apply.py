"""The server's step of a tick (``tick_fused.server_apply``) on the CPU.

``server_apply_ref`` is the plain twin of the one-launch CUDA kernel and
the version both cohort engines run on CPU tensors.  It is held:

* bit for bit against the device engine's server step as it was written
  before the kernel took it over: a masked sum over the overflow bucket,
  ``ovf_due + slot``, FedBuff's bank and flush ``where``s, ``bucket_apply``,
  a clone of the ring with one slot set to 0.0 and the broadcast push
  ``where(fired, v, bc_v)`` (written out below as ``old_server_step``),
  for the paper's strategy, FedAsync and FedBuff, each with no far tier
  and with one whose entry is due or not, the flags set and clear, 0, 1
  and 2 fired broadcast rows, and -0.0 planted in v, the slot, the
  overflow entry and the buffer;
* within the port's float tolerance (rtol 1e-5, atol 1e-7; FedAsync's
  sum over the strata, which jit may reorder and contract, within
  SUM_RTOL of its terms' magnitudes as in ``test_torch_kernels.py``; the
  resets exact) against the reference's own expressions
  (``repro/cohort/device.py``'s overflow pop, bank and ``bucket_apply``,
  run live in jax on the same numpy inputs);
* and its v' is a new tensor: a model handed out as a view of v before
  the step does not change.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tick_fused import ops as jops
from repro_torch.kernels import LAUNCHES, reset
from repro_torch.kernels.tick_fused import (bucket_apply, server_apply,
                                            server_apply_ref)

RTOL, ATOL = 1e-5, 1e-7
SUM_RTOL = 1e-5
R, Q, B = 4, 2, 4
KINDS = ("paper", "fedasync", "fedbuff")
# no far tier; a far tier with its entry due; one with none due
FAR = ("none", "due", "idle")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _state(seed, D, L, kind, far):
    """Engine-shaped server state (the device engine's field layout) from
    a seed, with -0.0 planted where the step's signs are decided: v
    (columns 0-3, 8-11), the due slot (2-5, 8-11), the overflow bucket's
    rows (0-1, 4-7, 8-11) and the buffer (1, 3, 5, 7, 8-11)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    A = R if kind == "fedasync" else 1
    slot = seed % L
    v = rng.normal(size=D).astype(f32)
    ring = rng.normal(size=(L, A, D)).astype(f32)
    ovf = rng.normal(size=(Q, A, D)).astype(f32)
    buf = rng.normal(size=D).astype(f32)
    v[[0, 1, 2, 3, 8, 9, 10, 11]] = -0.0
    ring[slot, :, [2, 3, 4, 5, 8, 9, 10, 11]] = -0.0
    ovf[:, :, [0, 1, 4, 5, 6, 7, 8, 9, 10, 11]] = -0.0
    buf[[1, 3, 5, 7, 8, 9, 10, 11]] = -0.0
    hit = np.zeros(Q, bool)
    if far == "due":
        hit[seed % Q] = True
    st = dict(
        v=v, bc_v=rng.normal(size=(B, D)).astype(f32), ovf_hit=hit,
        buf_vec=buf if kind == "fedbuff" else np.zeros(1, f32),
        dec=((rng.random(A) + 0.1).astype(f32) if A > 1
             else np.ones(1, f32)))
    if kind == "fedasync":
        # FedAsync keeps its buckets in the stratified rings; the plain
        # ones stay all +0.0 (nothing is scattered into them)
        st.update(upd_vec=np.zeros((L, D), f32), upd_kvec=ring,
                  ovf_vec=np.zeros((Q, D), f32), ovf_kvec=ovf)
    else:
        st.update(upd_vec=ring[:, 0], upd_kvec=np.zeros((1, 1, 1), f32),
                  ovf_vec=ovf[:, 0], ovf_kvec=np.zeros((1, 1, 1), f32))
    return st, slot


def _torch(st):
    return {k: torch.tensor(np.array(a)) for k, a in st.items()}


def old_server_step(st, slot, kind, far, has_arr, flush, fired):
    """The device engine's server step before ``server_apply``
    (``repro_torch/cohort/device.py``'s float phase as it stood), on
    torch tensors; returns the new (v, upd_vec, upd_kvec, ovf_vec,
    ovf_kvec, buf_vec, bc_v)."""
    stratified, buffered = kind == "fedasync", kind == "fedbuff"
    far_tier = far != "none"
    ones1 = torch.ones(1)
    upd_vec, upd_kvec = st["upd_vec"], st["upd_kvec"]
    ovf_vec, ovf_kvec = st["ovf_vec"], st["ovf_kvec"]
    if far_tier:
        ovf_hit = st["ovf_hit"]
        hit_f = ovf_hit.to(torch.float32)
        any_hit = ovf_hit.any()
        ovf_due = torch.where(any_hit, (st["ovf_vec"] * hit_f[:, None])
                              .sum(0), 0.0)
        ovf_vec = torch.where(ovf_hit[:, None], 0.0, st["ovf_vec"])
        if stratified:
            kvec_ovf = torch.where(any_hit, (st["ovf_kvec"] * hit_f[
                :, None, None]).sum(0), 0.0)
            ovf_kvec = torch.where(ovf_hit[:, None, None], 0.0,
                                   st["ovf_kvec"])
    if stratified:
        kvec_due = upd_kvec[slot]
        if far_tier:
            kvec_due = kvec_ovf + kvec_due
        v = bucket_apply(st["v"], kvec_due, st["dec"], has_arr)
        buf_vec = st["buf_vec"]
    else:
        arr_due = upd_vec[slot]
        if far_tier:
            arr_due = ovf_due + arr_due
        if buffered:
            buf_vec = torch.where(has_arr, st["buf_vec"] + arr_due,
                                  st["buf_vec"])
            v = bucket_apply(st["v"], buf_vec[None, :], ones1, flush)
            buf_vec = torch.where(flush, 0.0, buf_vec)
        else:
            v = bucket_apply(st["v"], arr_due[None, :], ones1, has_arr)
            buf_vec = st["buf_vec"]
    upd_vec = upd_vec.clone()
    upd_vec[slot] = 0.0
    if stratified:
        upd_kvec = upd_kvec.clone()
        upd_kvec[slot] = 0.0
    bc_v = (torch.where(fired[:, None], v[None, :], st["bc_v"])
            if bool(fired.any()) else st["bc_v"])
    return v, upd_vec, upd_kvec, ovf_vec, ovf_kvec, buf_vec, bc_v


def new_server_step(st, slot, kind, far, has_arr, flush, fired, *,
                    fn=server_apply):
    """The device engine's server step now: one ``server_apply`` call with
    the in-place operands of the engine's state; the same tuple."""
    stratified = kind == "fedasync"
    if stratified:
        due, ovf = st["upd_kvec"][slot], st["ovf_kvec"]
    else:
        due, ovf = st["upd_vec"][slot:slot + 1], st["ovf_vec"][:, None]
    far_tier = far != "none"
    v = fn(st["v"], due, st["dec"], has_arr, reset=True,
           ovf=ovf if far_tier else None,
           ovf_hit=st["ovf_hit"] if far_tier else None,
           buf=st["buf_vec"] if kind == "fedbuff" else None, flush=flush,
           bc_v=st["bc_v"] if bool(fired.any()) else None, fired=fired)
    return (v, st["upd_vec"], st["upd_kvec"], st["ovf_vec"],
            st["ovf_kvec"], st["buf_vec"], st["bc_v"])


def _cases():
    for kind, far, arr, fl, nf in itertools.product(
            KINDS, FAR, (True, False), (True, False), (0, 1, 2)):
        if kind != "fedbuff" and fl:
            continue
        yield kind, far, arr, fl, nf


CASES = list(_cases())
NAMES = ("v", "upd_vec", "upd_kvec", "ovf_vec", "ovf_kvec", "buf_vec",
         "bc_v")


def _flags(arr, fl, nf):
    fired = torch.zeros(B, dtype=torch.bool)
    fired[1:1 + nf] = True
    return torch.tensor(arr), torch.tensor(fl), fired


@pytest.mark.parametrize("L", [1, 2, 4])
@pytest.mark.parametrize("D", [785, 37])
@pytest.mark.parametrize("kind,far,arr,fl,nf", CASES)
def test_twin_is_the_old_server_step_bit_for_bit(kind, far, arr, fl, nf, D,
                                                  L):
    seed = D * 10 + L
    np_st, slot = _state(seed, D, L, kind, far)
    has_arr, flush, fired = _flags(arr, fl, nf)
    want = old_server_step(_torch(np_st), slot, kind, far, has_arr, flush,
                           fired)
    st = _torch(np_st)
    got = new_server_step(st, slot, kind, far, has_arr, flush, fired,
                          fn=server_apply_ref)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name
    # the planted signs reached the output where the step decides them
    if arr and kind == "paper" and far == "none":
        assert torch.signbit(got[0][8:12]).logical_not().all()


def _jax_server_step(st, slot, kind, far, has_arr, flush, fired):
    """The reference's server step (``repro/cohort/device.py``: the
    overflow pop under ``lax.cond``, ``overflow + ring slot``, the
    FedBuff bank, ``bucket_apply`` on its CPU path, the slot's reset and
    the cascade's ``bc_v.at[b].set(v)``), on numpy inputs."""
    stratified, buffered = kind == "fedasync", kind == "fedbuff"
    j = {k: jnp.asarray(a) for k, a in st.items()}
    ones1 = jnp.ones((1,), jnp.float32)
    D = st["v"].shape[0]
    ovf_vec, ovf_kvec = j["ovf_vec"], j["ovf_kvec"]
    if far != "none":
        ovf_hit = j["ovf_hit"]
        hit_f = ovf_hit.astype(jnp.float32)

        def pop(_):
            out = (jnp.sum(j["ovf_vec"] * hit_f[:, None], axis=0),)
            if stratified:
                out += (jnp.sum(j["ovf_kvec"] * hit_f[:, None, None],
                                axis=0),)
            return out

        def no_pop(_):
            out = (jnp.zeros((D,), jnp.float32),)
            if stratified:
                out += (jnp.zeros((R, D), jnp.float32),)
            return out

        popped = jax.lax.cond(jnp.any(ovf_hit), pop, no_pop, None)
        arr_due = popped[0] + j["upd_vec"][slot]
        kvec_due = popped[1] + j["upd_kvec"][slot] if stratified else None
        ovf_vec = jnp.where(ovf_hit[:, None], 0.0, j["ovf_vec"])
        if stratified:
            ovf_kvec = jnp.where(ovf_hit[:, None, None], 0.0, j["ovf_kvec"])
    else:
        arr_due = j["upd_vec"][slot]
        kvec_due = j["upd_kvec"][slot] if stratified else None
    buf_vec = j["buf_vec"]
    if stratified:
        v = jops.bucket_apply(j["v"], kvec_due, j["dec"], has_arr)
    elif buffered:
        buf_vec = jnp.where(has_arr, j["buf_vec"] + arr_due, j["buf_vec"])
        v = jops.bucket_apply(j["v"], buf_vec[None, :], ones1, flush)
        buf_vec = jnp.where(flush, jnp.zeros((D,), jnp.float32), buf_vec)
    else:
        v = jops.bucket_apply(j["v"], arr_due[None, :], ones1, has_arr)
    upd_vec = j["upd_vec"].at[slot].set(jnp.zeros((D,), jnp.float32))
    upd_kvec = (j["upd_kvec"].at[slot].set(jnp.zeros((R, D), jnp.float32))
                if stratified else j["upd_kvec"])
    bc_v = j["bc_v"]
    for b in np.flatnonzero(fired):
        bc_v = bc_v.at[int(b)].set(v)
    return tuple(np.asarray(x) for x in (v, upd_vec, upd_kvec, ovf_vec,
                                         ovf_kvec, buf_vec, bc_v))


@pytest.mark.parametrize("D", [785, 37])
@pytest.mark.parametrize("kind,far,arr,fl,nf", CASES)
def test_twin_matches_the_reference(kind, far, arr, fl, nf, D):
    L = 2
    np_st, slot = _state(D + 7, D, L, kind, far)
    has_arr, flush, fired = _flags(arr, fl, nf)
    want = _jax_server_step(np_st, slot, kind, far, np.bool_(arr),
                            np.bool_(fl), fired.numpy())
    got = new_server_step(_torch(np_st), slot, kind, far, has_arr, flush,
                          fired)
    # FedAsync: |v| + sum_a |dec_a| (|overflow row_a| + |slot row_a|)
    hit = np_st["ovf_hit"][:, None, None] if far != "none" else 0.0
    mag = np.abs(np_st["v"]) + (np.abs(np_st["dec"])[:, None] * (
        np.abs(np_st["ovf_kvec"] * hit).sum(0)
        + np.abs(np_st["upd_kvec"][slot]))).sum(0)
    for name, a, b in zip(NAMES, got, want):
        a = a.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name in ("upd_vec", "upd_kvec", "ovf_vec", "ovf_kvec"):
            assert np.array_equal(a, b), name      # resets and untouched
        elif kind == "fedasync" and arr and name in ("v", "bc_v"):
            assert (np.abs(a - b) <= SUM_RTOL * mag + 1e-30).all(), name
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_v_prime_is_a_new_tensor(kind):
    """A view of v taken before the step (the model a user holds) keeps
    its bits; v' lives elsewhere; the call counts no launch on the CPU."""
    np_st, slot = _state(3, 37, 2, kind, "due")
    st = _torch(np_st)
    held = st["v"][:]
    before = held.clone()
    has_arr, flush, fired = _flags(True, True, 2)
    reset()
    v2 = new_server_step(st, slot, kind, "due", has_arr, flush, fired)[0]
    assert LAUNCHES["bucket_apply"] == 0
    assert v2.data_ptr() != held.data_ptr()
    assert torch.equal(_bits(held), _bits(before))
    assert not torch.equal(_bits(v2), _bits(before))


def test_the_server_model_a_user_holds_does_not_change():
    """Through the device engine: the server model handed out after a
    round stays as it was while the engine runs on."""
    from repro_torch import DeviceCohortSimulator, LogRegTask
    from repro_torch.data import make_binary_dataset
    X, y = make_binary_dataset(60, 6, seed=0)
    sim = DeviceCohortSimulator(LogRegTask(X, y, sample_seed=0),
                                n_clients=4, sizes_per_client=[2, 3],
                                round_stepsizes=[0.1, 0.05], d=1, seed=0,
                                block=2, device="cpu")
    sim.engine.segment(target_k=1, tick_limit=10_000)
    held = sim.server_model
    before = {k: t.clone() for k, t in held.items()}
    sim.engine.segment(target_k=3, tick_limit=10_000)
    assert int(sim.engine.state.server_k) >= 3
    for k, t in held.items():
        assert torch.equal(t, before[k]), k
    assert not torch.equal(sim.server_model["w"], before["w"])


def test_bucket_apply_takes_the_engine_bool_flag():
    """The reference's entry point stays, served by the same kernel on the
    card; on the CPU it is the plain version with the bool flag as is."""
    v = torch.tensor([1.0, -0.0, 2.0])
    rows = torch.tensor([[0.5, -0.0, 1.0]])
    out = bucket_apply(v, rows, torch.ones(1), torch.tensor(True))
    assert torch.equal(out, torch.tensor([0.5, 0.0, 1.0]))
    assert not torch.signbit(out[1])
    assert torch.equal(bucket_apply(v, rows, torch.ones(1),
                                    torch.tensor(False)), v)
