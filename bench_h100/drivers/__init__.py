"""One module per kind of entry a cell's window drives; each has
run(context) -> harness.Outcome."""
