"""learner.update_ms: the PPO update phase (every minibatch of every
epoch, ``train_step.update``), host clock with the card synchronised on
both sides, mean ms over the traced steps."""


def read(ctx):
    spans = ctx.get("spans", {}).get("update")
    return 1e3 * sum(spans) / len(spans) if spans else None
