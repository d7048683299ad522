"""rollout.train_ms: a train step's rollout (``train_step.rollout``: the
fused policy-in-kernel episode for EV), host clock with the card
synchronised on both sides, mean ms over the traced steps."""


def read(ctx):
    spans = ctx.get("spans", {}).get("rollout")
    return 1e3 * sum(spans) / len(spans) if spans else None
