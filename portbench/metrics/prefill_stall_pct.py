"""Session admission: the share of the traced span that the scheduler
spends prefilling admitted prompts (``repro_torch.lm.admit.prefill``, from
the prefills' submission to the last result), during which no stream
decodes.  None where the span holds no admission."""
from portbench.harness import spans


def read(run):
    return spans.span_pct(run, "repro_torch.lm.admit.prefill")
