"""Reads from the device that the program makes on the substep path, over
the traced frames' substeps: the sum over sites of
StepDiagnostics.host_reads (utils/trace.read counts each, always on: the
CFL read, the viscosity test, each CG's convergence reads, the frame's
diagnostics). None for a program without the counter."""


def read(run):
    reads = [getattr(d, "host_reads", None) for d in run.diags]
    if not run.substeps or any(r is None for r in reads):
        return None
    return sum(sum(r.values()) for r in reads) / run.substeps
