"""Device operations (kernels, copies, sets) launched from inside the
traced frames, over the traced substeps: the substep stages' launch count,
which sets the pace where the host is the bottleneck."""


def read(run):
    if not run.substeps:
        return None
    return run.trace["launches"] / run.substeps
