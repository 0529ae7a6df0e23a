"""The reference's tutorial apps (``apps/`` at the repository's root),
the ones ported so far. Each module has ``main(argv)``; run one with
``python -m analytics_zoo_tpu_torch.apps <name> [args...]``. They run on
the card unless given ``--device cpu``."""

APPS = [
    "dogs_vs_cats",
    "recommendation_ncf",
    "recommendation_wide_n_deep",
    "web_service_sample",
]
