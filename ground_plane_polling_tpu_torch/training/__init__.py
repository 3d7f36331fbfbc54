"""Training: losses, the train step, the plateau schedule, checkpoints, and
`fit` with its validation sweep."""
