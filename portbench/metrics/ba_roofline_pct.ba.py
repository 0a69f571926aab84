"""ba_roofline_pct.ba: the whole solve's share of the roofline, in %: the
least time the solves completed in the traced window need, over the
window.  A solve's work is counted from the problem's shapes and the
algorithm of run_large_ba as it stands (commit a3f7eac): per LM
iteration one linearisation at the trial point, CG + 1 applies of the
Schur coupling (one per CG iteration and one for the right-hand side) and
one back-substitution gather, and one more linearisation at the start.
No launch is read, so it reads the same work whatever implements it."""

from portbench import core
from portbench.reference.roofline import ba_bound

LINEARISATIONS_PER_LM, EXTRA_LINEARISATIONS = 1, 1
GATHERS_PER_LM = 1


def read(record):
    t, solves = record.get("trace"), record.get("solves")
    if not t or not solves or t["busy_s"] <= 0:
        return None
    s = record["config"]["solver"]
    lm, cg = int(s["lm_iterations"]), int(s["cg_iterations"])
    shape = core.ba_shape(record)
    ms = ((LINEARISATIONS_PER_LM * lm + EXTRA_LINEARISATIONS)
          * ba_bound("ba_linearize", *shape)["bound_ms"]
          + lm * (cg + 1) * ba_bound("schur_apply", *shape)["bound_ms"]
          + GATHERS_PER_LM * lm * ba_bound("schur_gather", *shape)["bound_ms"])
    return 100.0 * solves * 1e-3 * ms / t["window_s"]
