"""Dispatch an NmfConfig to concrete update-step callables.

`build_dense_update(config)` returns a triple:

  make_aux(V)            -> aux pytree of per-problem constants (confidence
                            matrix C for weighted MU, smoothing matrix S for
                            nsNMF, () otherwise) computed once outside the
                            iteration loop;
  update(V, aux, W, H)   -> (W, H) one full iteration, pure & jittable;
  effective_h(aux, H)    -> the H to use in error metrics (S @ H for nsNMF,
                            identity otherwise), so the reported error is
                            always ||V - W * effective_h(H)||.

This mirrors the reference dispatcher's {algorithm x precision} dispatch
(SURVEY.md C2): precision is handled by the arrays' dtype; algorithm by this
registry.
"""

from __future__ import annotations

import jax.numpy as jnp

from nmftpu.config import Algorithm, NmfConfig, Objective
from nmftpu.linalg import dense as D


def build_dense_update(config: NmfConfig):
    eps = config.eps
    order = config.update_order
    alg = config.algorithm
    obj = config.objective
    if config.mu_style == "jacobi" and alg is Algorithm.MU:
        # simultaneous half-steps from the incoming factors (config
        # validation restricts this to the dense MU Frobenius/KL
        # builders below); linalg._apply_order handles the coupling
        order = "jacobi"

    if (config.v_storage == "int8" and alg is not Algorithm.MU
            and obj is Objective.FROBENIUS):
        # int8 x int8 dots for the ALS/ACLS/AHCLS/GDCLS/nsNMF family
        # under Frobenius (nsNMF-KL routes through the quantized-KL branch
        # below); config validation guarantees no confidence weighting
        # here. V is quantized once into aux; the O(nmr) right-hand-side
        # contractions run int8 x int8 -> int32 (the r x r solves and MU
        # denominators stay exact f32). The int8 contraction is exact
        # integer math on every platform.

        def effective_h(aux, H):
            return H

        if alg in (Algorithm.ALS, Algorithm.ACLS, Algorithm.AHCLS):
            from nmftpu.sparse_ops import _als_family_shifts

            sw, sh, ow, oh = _als_family_shifts(config)

            def make_aux(V):
                return D.quantize_v(V)

            def update(V, aux, W, H):
                return D.als_family_update_int8x8(
                    aux[0], aux[1], W, H, shift_w=sw, shift_h=sh,
                    off_w=ow, off_h=oh, eps=eps, order=order,
                )

        elif alg is Algorithm.GDCLS:
            lt = config.lambda_tik

            def make_aux(V):
                return D.quantize_v(V)

            def update(V, aux, W, H):
                return D.gdcls_update_int8x8(
                    aux[0], aux[1], W, H, lambda_tik=lt, eps=eps,
                    order=order,
                )

        elif alg is Algorithm.NSNMF:
            theta = config.theta
            rank = config.rank

            def make_aux(V):
                Vq, scale = D.quantize_v(V)
                S = D.nsnmf_smoothing_matrix(rank, theta,
                                             dtype=jnp.float32)
                return (Vq, scale, S)

            def update(V, aux, W, H):
                return D.nsnmf_update_frobenius_int8x8(
                    aux[0], aux[1], W, H, aux[2], eps=eps, order=order
                )

            def effective_h(aux, H):
                return aux[2] @ H

        else:
            raise ValueError(f"unknown algorithm: {alg}")

        return make_aux, update, effective_h

    if (config.v_storage == "bfloat16" and alg is not Algorithm.MU
            and obj is Objective.FROBENIUS):
        # bf16-stored V for the ALS family under Frobenius: previously the
        # knob was silently ignored on these algorithms. The densified
        # module's family updates take any dense low-precision V — the
        # O(nmr) right-hand sides (_big_vht/_big_wtv) read half the V
        # traffic and contract bf16 x bf16 -> f32; r x r
        # solves stay exact f32.
        from nmftpu import densified as DFB

        def effective_h(aux, H):
            return H

        if alg in (Algorithm.ALS, Algorithm.ACLS, Algorithm.AHCLS):
            from nmftpu.sparse_ops import _als_family_shifts

            sw, sh, ow, oh = _als_family_shifts(config)

            def make_aux(V):
                return (V.astype(jnp.bfloat16),)

            def update(V, aux, W, H):
                return DFB.als_family_update_densified(
                    aux[0], W, H, shift_w=sw, shift_h=sh,
                    off_w=ow, off_h=oh, eps=eps, order=order,
                )

        elif alg is Algorithm.GDCLS:
            lt = config.lambda_tik

            def make_aux(V):
                return (V.astype(jnp.bfloat16),)

            def update(V, aux, W, H):
                return DFB.gdcls_update_densified(
                    aux[0], W, H, lambda_tik=lt, eps=eps, order=order
                )

        elif alg is Algorithm.NSNMF:
            theta = config.theta
            rank = config.rank

            def make_aux(V):
                S = D.nsnmf_smoothing_matrix(rank, theta,
                                             dtype=jnp.float32)
                return (V.astype(jnp.bfloat16), S)

            def update(V, aux, W, H):
                return DFB.nsnmf_update_densified(
                    aux[0], W, H, aux[1], eps=eps, order=order
                )

            def effective_h(aux, H):
                return aux[1] @ H

        else:
            raise ValueError(f"unknown algorithm: {alg}")

        return make_aux, update, effective_h

    if alg is Algorithm.MU:
        if obj is Objective.FROBENIUS and config.alpha_confidence > 0.0:
            alpha = config.alpha_confidence

            if config.v_storage in ("bfloat16", "int8"):
                # low-precision-stored V: the confidence C = 1 + αV is
                # rebuilt per row panel in registers (never an nm-sized
                # aux), with the int8 scale applied before weighting
                from nmftpu import densified as DFW

                if config.v_storage == "int8":

                    def make_aux(V):
                        return D.quantize_v(V)

                    def update(V, aux, W, H):
                        return DFW.mu_update_frobenius_weighted_densified(
                            aux[0], W, H, alpha, eps=eps, order=order,
                            scale=aux[1],
                        )
                else:

                    def make_aux(V):
                        return (V.astype(jnp.bfloat16),)

                    def update(V, aux, W, H):
                        return DFW.mu_update_frobenius_weighted_densified(
                            aux[0], W, H, alpha, eps=eps, order=order
                        )
            else:

                def make_aux(V):
                    return (jnp.asarray(1.0, V.dtype) + alpha * V,)

                def update(V, aux, W, H):
                    return D.mu_update_frobenius_weighted(
                        V, aux[0], W, H, eps=eps, order=order
                    )

        elif obj is Objective.FROBENIUS and config.v_storage == "int8":
            # V held once as int8 + scale, dequantized to bf16 for a
            # bf16 x bf16 -> f32 contraction: faster on the H100 than
            # XLA's int8 x int8 -> int32 dot (PERF.md)
            def make_aux(V):
                return D.quantize_v(V)

            def update(V, aux, W, H):
                Vb = aux[0].astype(jnp.bfloat16) * aux[1].astype(
                    jnp.bfloat16
                )
                return D.mu_update_frobenius_bf16v(
                    Vb, W, H, eps=eps, order=order
                )

        elif obj is Objective.FROBENIUS and config.v_storage == "bfloat16":

            def make_aux(V):
                return (V.astype(jnp.bfloat16),)

            def update(V, aux, W, H):
                return D.mu_update_frobenius_bf16v(
                    aux[0], W, H, eps=eps, order=order
                )

        elif obj is Objective.FROBENIUS:

            def make_aux(V):
                return ()

            def update(V, aux, W, H):
                return D.mu_update_frobenius(V, W, H, eps=eps, order=order)

        elif obj is Objective.BETA and config.v_storage == "float32":
            beta = config.beta

            def make_aux(V):
                return ()

            def update(V, aux, W, H):
                return D.mu_update_beta(V, W, H, beta, eps=eps,
                                        order=order)

        elif obj is Objective.BETA and config.v_storage == "int8":
            # int8-stored V under general beta: V enters the numerator
            # linearly, so the symmetric scale folds in after the
            # blockwise contraction (same contract as quantized KL).
            from nmftpu import densified as DF

            beta = config.beta

            def make_aux(V):
                return D.quantize_v(V)

            def update(V, aux, W, H):
                return DF.mu_update_beta_densified(
                    aux[0], W, H, beta, eps=eps, order=order,
                    scale=aux[1],
                )

        elif obj is Objective.BETA:  # bf16-stored V
            from nmftpu import densified as DF

            beta = config.beta

            def make_aux(V):
                return (V.astype(jnp.bfloat16),)

            def update(V, aux, W, H):
                return DF.mu_update_beta_densified(
                    aux[0], W, H, beta, eps=eps, order=order
                )

        elif config.v_storage == "int8":  # KL, int8-stored V
            # Quantized-KL: V held once as int8 + one symmetric scale
            # (quarter traffic), blockwise bf16-GEMM half-steps with the
            # scalar folded into the numerator after the contraction
            # (exact — see _kl_numer_w_blocked). Zeros quantize to zeros,
            # so the KL support pattern is preserved.
            from nmftpu import densified as DF

            def make_aux(V):
                return D.quantize_v(V)

            def update(V, aux, W, H):
                return DF.mu_update_kl_densified(
                    aux[0], W, H, eps=eps, order=order, scale=aux[1]
                )

        elif config.v_storage == "bfloat16":  # KL, bf16-stored V
            from nmftpu import densified as DF

            def make_aux(V):
                return (V.astype(jnp.bfloat16),)

            def update(V, aux, W, H):
                return DF.mu_update_kl_densified(
                    aux[0], W, H, eps=eps, order=order
                )

        else:  # KL

            def make_aux(V):
                return ()

            def update(V, aux, W, H):
                return D.mu_update_kl(V, W, H, eps=eps, order=order)

        def effective_h(aux, H):
            return H

    elif alg is Algorithm.ALS:
        if config.alpha_confidence > 0.0:
            # iALS: exact per-row weighted solves (config validation
            # pins v_storage to float32 here)
            alpha = config.alpha_confidence
            lw, lh = config.lambda_w, config.lambda_h

            def make_aux(V):
                return ()

            def update(V, aux, W, H):
                return D.als_update_weighted(
                    V, W, H, alpha, lambda_w=lw, lambda_h=lh, eps=eps,
                    order=order,
                )
        else:

            def make_aux(V):
                return ()

            def update(V, aux, W, H):
                return D.als_update(V, W, H, eps=eps, order=order)

        def effective_h(aux, H):
            return H

    elif alg is Algorithm.HALS:
        lw, lh = config.lambda_w, config.lambda_h
        l1w, l1h = config.l1_w, config.l1_h

        def make_aux(V):
            return ()

        def update(V, aux, W, H):
            return D.hals_update(V, W, H, eps=eps, order=order,
                                 l2_w=lw, l2_h=lh, l1_w=l1w, l1_h=l1h)

        def effective_h(aux, H):
            return H

    elif alg is Algorithm.ACLS:
        lw, lh = config.lambda_w, config.lambda_h

        def make_aux(V):
            return ()

        def update(V, aux, W, H):
            return D.acls_update(
                V, W, H, lambda_w=lw, lambda_h=lh, eps=eps, order=order
            )

        def effective_h(aux, H):
            return H

    elif alg is Algorithm.AHCLS:
        lw, lh = config.lambda_w, config.lambda_h
        aw, ah = config.alpha_w, config.alpha_h

        def make_aux(V):
            return ()

        def update(V, aux, W, H):
            return D.ahcls_update(
                V, W, H, lambda_w=lw, lambda_h=lh, alpha_w=aw, alpha_h=ah,
                eps=eps, order=order,
            )

        def effective_h(aux, H):
            return H

    elif alg is Algorithm.GDCLS:
        lt = config.lambda_tik

        def make_aux(V):
            return ()

        def update(V, aux, W, H):
            return D.gdcls_update(V, W, H, lambda_tik=lt, eps=eps, order=order)

        def effective_h(aux, H):
            return H

    elif alg is Algorithm.NSNMF:
        theta = config.theta
        rank = config.rank
        obj_name = "frobenius" if obj is Objective.FROBENIUS else "kl"

        if obj is Objective.KL and config.v_storage in ("bfloat16", "int8"):
            # Low-precision-stored V under KL: blockwise bf16-GEMM
            # half-steps vs the smoothed partners; int8 folds its scalar
            # scale into the numerators (see mu_update_kl_densified).
            from nmftpu import densified as DF

            if config.v_storage == "int8":

                def make_aux(V):
                    S = D.nsnmf_smoothing_matrix(
                        rank, theta, dtype=jnp.float32
                    )
                    return (S,) + tuple(D.quantize_v(V))

                def update(V, aux, W, H):
                    return DF.nsnmf_update_kl_densified(
                        aux[1], W, H, aux[0], eps=eps, order=order,
                        scale=aux[2],
                    )
            else:

                def make_aux(V):
                    S = D.nsnmf_smoothing_matrix(
                        rank, theta, dtype=jnp.float32
                    )
                    return (S, V.astype(jnp.bfloat16))

                def update(V, aux, W, H):
                    return DF.nsnmf_update_kl_densified(
                        aux[1], W, H, aux[0], eps=eps, order=order
                    )
        else:

            def make_aux(V):
                return (
                    D.nsnmf_smoothing_matrix(rank, theta, dtype=V.dtype),
                )

            def update(V, aux, W, H):
                return D.nsnmf_update(
                    V, W, H, aux[0], eps=eps, objective=obj_name,
                    order=order,
                )

        def effective_h(aux, H):
            return aux[0] @ H

    else:
        raise ValueError(f"unknown algorithm: {alg}")

    return make_aux, update, effective_h
