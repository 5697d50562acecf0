"""
Multiclass meta-estimators of the port. For now this module holds only
:func:`_iterative_fit_spec`, the one builder of
:class:`~skdist_tpu_torch.parallel.IterativeKernelSpec` for the
convergence-compacted path, which the CV search uses (and which
one-vs-rest, one-vs-one and the feature eliminator will use when they
are ported; ROADMAP.md, queue 1). Counterpart of
``skdist_tpu/distribute/multiclass.py``'s ``_iterative_fit_spec``.
"""

from ..parallel import IterativeKernelSpec


def _iterative_fit_spec(est_cls, meta, static, n_slice, derive,
                        fallback_kernel, outputs=None, rung_score=None):
    """Wrap an estimator family's iteration-sliced fit kernels
    (``_build_fit_slice_kernels``) as an
    :class:`~skdist_tpu_torch.parallel.IterativeKernelSpec`.

    ``derive(shared, task) -> (op, y, w, hyper)`` gives the lanes'
    sub-problem (the CV search: fold-masked weights). ``outputs(params,
    shared, task)`` turns the finalized fit params into the spec's
    outputs (the search scores them on the fold masks); None returns the
    params. ``rung_score(params, shared, task) -> (T,)`` adds the
    adaptive rung evaluator: params shaped from the live carry through
    the family's ``score_params`` kernel, then scored. ``fallback_kernel``
    is the classic kernel with the same outputs."""
    ks = est_cls._build_fit_slice_kernels(meta, static, n_slice)

    def init(shared, task):
        return ks["init"](*derive(shared, task))

    def restart(shared, task, carry, slots):
        return ks["restart"](*derive(shared, task), carry, slots)

    def step(shared, task, carry):
        return ks["step"](*derive(shared, task), carry)

    def finalize(shared, task, carry):
        params = ks["finalize"](*derive(shared, task), carry)
        return params if outputs is None else outputs(params, shared, task)

    score = None
    if rung_score is not None:
        live = ks.get("score_params", ks["finalize"])

        def score(shared, task, carry):
            return rung_score(live(*derive(shared, task), carry), shared,
                              task)

    converged = None
    if "converged" in ks:
        def converged(shared, task, carry):
            return ks["converged"](*derive(shared, task), carry)

    return IterativeKernelSpec(
        init, restart, step, finalize, ks["finalize_keys"],
        fallback=fallback_kernel, score=score, converged=converged,
        max_iter=ks.get("max_iter"), iter_key=ks.get("iter_key", "it"),
    )
