"""The share of particle-passes that the particle engine's fixed-capacity
structures held: 1 - bucket_overflow / (particles x passes x substeps) over
the traced frames, in %. The passes that can leave a particle out are the
liquid-SDF slot table (pass A), and where the configuration runs them, the
pass-A visit plan ("stale"), the midpoint visit plan (pass B "plan") and
the pushback plan ("kernel"); the "table" engine's two slot tables."""


def passes(sim_config: dict) -> int:
    if sim_config.get("particle_engine", "table") == "table":
        return 2
    if sim_config.get("particle_engine") == "stream":
        return 0
    return (1 + (sim_config.get("pallas_pass_a", "sort") == "stale")
            + (sim_config.get("pallas_pass_b", "plan") == "plan")
            + (sim_config.get("pallas_pushback", "gather") == "kernel"))


def read(run):
    n = passes(run.spec.get("sim_config", {}))
    if not (run.substeps and n):
        return None
    dropped = sum(d.bucket_overflow for d in run.diags)
    return 100.0 * (1.0 - dropped / (run.particles * n * run.substeps))
