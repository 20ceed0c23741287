"""EAGLE head training (port of `hsd_tpu/train/`): the conversation data
pipeline and draft vocabulary (`data`, `draft_vocab`), the EAGLE-3 and
EAGLE-1 steps over a frozen target (`eagle3`, `eagle1`), offline feature
shards (`features`), the rollout probes (`probes`) and the loop with
auto-resume (`loop`)."""
