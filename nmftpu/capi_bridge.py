"""Python half of the C ABI (native/nmftpu_capi.cc).

The C side passes raw pointers as integers; this module wraps them as
numpy views via ctypes (zero-copy in, one copy out into the caller's
result buffers) and drives the normal engine. Kept free of any jax import
at module import time so embedding stays cheap until first use.
"""

from __future__ import annotations

import ctypes

import numpy as np


def initialize() -> int:
    import os

    # NMFTPU_PLATFORM pins the backend (e.g. cpu on a machine with a
    # GPU), the same switch as the examples.
    plat = os.environ.get("NMFTPU_PLATFORM")
    if plat:
        os.environ["JAX_PLATFORMS"] = plat
        import jax

        try:
            jax.config.update("jax_platforms", plat)
        except Exception:
            pass

    import nmftpu.compat as compat

    return compat.initialize()


def version() -> str:
    import nmftpu

    return nmftpu.__version__


def device_count() -> int:
    import jax

    return len(jax.devices())


def choose_device(index: int) -> int:
    import nmftpu.compat as compat

    return compat.choose_device(None if index < 0 else index)


def _view(ptr: int, shape, dtype):
    if ptr == 0:
        return None
    ctype = np.ctypeslib.as_ctypes_type(np.dtype(dtype))
    n = int(np.prod(shape))
    buf = ctypes.cast(ptr, ctypes.POINTER(ctype * n)).contents
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def compute_from_buffers(
    n, m, rank,
    algorithm, objective, init_method,
    seed, num_iterations, num_runs, check_interval,
    threshold_type, threshold_value,
    lambda_w, lambda_h, alpha_w, alpha_h, lambda_tik, theta,
    alpha_confidence, beta,
    dense_ptr, indptr_ptr, indices_ptr, values_ptr, nnz,
    w0_ptr, h0_ptr, out_w_ptr, out_h_ptr,
    stats_cb_ptr=0, stats_user_data=0,
):
    import nmftpu
    from nmftpu.sparse import SparseCSR

    knobs = {}
    for name, val in (
        ("lambda_w", lambda_w), ("lambda_h", lambda_h),
        ("lambda_tik", lambda_tik), ("alpha_confidence", alpha_confidence),
    ):
        if val:
            knobs[name] = val
    if alpha_w:
        knobs["alpha_w"] = alpha_w
    if alpha_h:
        knobs["alpha_h"] = alpha_h
    if theta:
        knobs["theta"] = theta
    if objective == "beta-divergence":
        # beta=0.0 is a real value here (Itakura-Saito), so the knob is
        # gated on the objective string, not on nonzero-ness
        knobs["beta"] = beta

    if dense_ptr:
        data = np.array(_view(dense_ptr, (n, m), np.float32), copy=True)
    else:
        indptr = np.array(_view(indptr_ptr, (n + 1,), np.int64), copy=True)
        indices = np.array(_view(indices_ptr, (nnz,), np.int32), copy=True)
        values = np.array(_view(values_ptr, (nnz,), np.float32), copy=True)
        data = SparseCSR(indptr, indices, values, (n, m))

    W0 = _view(w0_ptr, (n, rank), np.float32)
    H0 = _view(h0_ptr, (rank, m), np.float32)

    # Per-check stats callback + cancellation (reference C17/§3.2): the
    # C function pointer crosses as an integer; calling it returns
    # nonzero to cancel. The stats record rides the engine's async
    # debug.callback while cancellation latches a flag the ordered
    # interrupt poll reads at the NEXT convergence check — so a cancel
    # takes effect one check after the record that requested it.
    callback = interrupt = None
    if stats_cb_ptr:
        import time

        cb_type = ctypes.CFUNCTYPE(
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_double, ctypes.c_double,
            ctypes.c_double,
        )
        c_fn = cb_type(stats_cb_ptr)
        user_data = ctypes.c_void_p(stats_user_data or None)
        t0 = time.perf_counter()
        cancelled = [False]

        def callback(run_idx, iteration, error, delta):
            rc = c_fn(user_data, int(run_idx), int(iteration),
                      float(error), float(delta),
                      (time.perf_counter() - t0) * 1e3)
            if rc:
                cancelled[0] = True

        def interrupt():
            return cancelled[0]

    res = nmftpu.nmf(
        data, rank,
        algorithm=algorithm, objective=objective, init=init_method,
        seed=seed, num_iterations=num_iterations, num_runs=num_runs,
        threshold=threshold_value, threshold_type=threshold_type,
        check_interval=check_interval,
        W0=np.array(W0, copy=True) if W0 is not None else None,
        H0=np.array(H0, copy=True) if H0 is not None else None,
        callback=callback, interrupt=interrupt,
        **knobs,
    )

    _view(out_w_ptr, (n, rank), np.float32)[:] = np.asarray(res.W)
    _view(out_h_ptr, (rank, m), np.float32)[:] = np.asarray(res.H)
    return (
        float(res.frobenius_error), float(res.rmsd),
        int(res.num_iterations), int(bool(res.converged)),
    )
