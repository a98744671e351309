"""The harness: finding parts by name (`spec`), the run (`runner`), the
model and restored rows (`model`), seeds, the trace and the readers'
shared arithmetic."""
