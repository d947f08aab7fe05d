"""Stream time of the particle engine's stages over the traced frames'
substeps, in ms: the program's own spans pass_a, liquid_sdf, p2g_combine,
g2p, midpoint_sample and pushback (StepDiagnostics.stages: the time the
stream took from each span's start marker to its end marker). None where
the frames hold no stages (a program without them)."""

STAGES = ("pass_a", "liquid_sdf", "p2g_combine", "g2p", "midpoint_sample",
          "pushback")


def read(run):
    stages = [getattr(d, "stages", None) for d in run.diags]
    if not run.substeps or not all(stages):
        return None
    return sum(s[n]["stream_ms"] for s in stages for n in STAGES
               if n in s) / run.substeps
