"""Stream time of the viscosity solve over the traced frames' substeps, in
ms: the program's own spans viscosity_build (volume grids and system),
viscosity_solve (the preconditioner's hierarchy and MG-PCG) and
viscosity_apply (StepDiagnostics.stages: the time the stream took from
each span's start marker to its end marker). None where the frames hold
no stages (a program without them) or ran no viscosity solve."""

STAGES = ("viscosity_build", "viscosity_solve", "viscosity_apply")


def read(run):
    stages = [getattr(d, "stages", None) for d in run.diags]
    if not run.substeps or not all(stages):
        return None
    ran = [s[n]["stream_ms"] for s in stages for n in STAGES if n in s]
    return sum(ran) / run.substeps if ran else None
