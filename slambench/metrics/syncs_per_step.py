"""syncs_per_step (syncs/step, lower, program_counter; layer: entry):
host synchronisations made by the program's own lines in the traced
stretch, a front-end step, as ``torch.cuda.set_sync_debug_mode("warn")``
reports them. Moves frame_ms_p90."""


def read(run):
    rec = run.record
    return None if rec is None else len(rec.syncs) / rec.steps
