"""Stream time of the pressure projection over the traced frames'
substeps, in ms: the program's own spans pressure_build, pressure_solve
(the preconditioner's hierarchy and MG-PCG) and pressure_apply
(StepDiagnostics.stages: the time the stream took from each span's start
marker to its end marker). None where the frames hold no stages (a
program without them)."""

STAGES = ("pressure_build", "pressure_solve", "pressure_apply")


def read(run):
    stages = [getattr(d, "stages", None) for d in run.diags]
    if not run.substeps or not all(stages):
        return None
    return sum(s[n]["stream_ms"] for s in stages for n in STAGES
               if n in s) / run.substeps
