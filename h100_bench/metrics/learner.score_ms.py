"""learner.score_ms: the re-scoring of the rollout and GAE
(``train_step.score``), host clock with the card synchronised on both
sides, mean ms over the traced steps."""


def read(ctx):
    spans = ctx.get("spans", {}).get("score")
    return 1e3 * sum(spans) / len(spans) if spans else None
