"""The drivers: each sets up and times one kind of cell (see
`harness/context.py` for the interface). A traffic mix names its driver."""
