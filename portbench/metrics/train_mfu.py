"""The window's training operations a second against the device's dense
bf16 peak, in percent: (6 * N + attention) a token times tokens a second,
N the parameters a token runs through and attention the causal products
(6 * L * S * heads * head_dim), both from the configuration's sizes."""


def read(run):
    w, peaks = run.window, run.peaks
    if not w.steps or peaks is None:
        return None
    mod, cj = run.model, run.config
    per_token = 6 * mod.params_per_token(cj) \
        + mod.attention_flops_per_token(cj, run.traffic["seq_len"])
    return 100.0 * per_token * w.tokens / w.ends[-1] / peaks["bf16"]
