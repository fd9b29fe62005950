"""ADMM iterations a step: ``StepInfo.n_iters`` summed over the traced
window's steps, over its steps. Layer: the step
(``integrators/admm_soa.py::SoAADMM3D.step``)."""


def read(ctx):
    iters = [n for _, n in ctx.window.infos]
    if not iters or any(n is None for n in iters):
        return None
    return sum(iters) / len(iters)
