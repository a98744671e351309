"""`test_torch_spec_mq.py`'s pin at spec depth 2 and page size 8: mq at
token and at page granularity against one scan trace, which both cases
share (`scan_traces`, run once for this file)."""

import pytest

from test_torch_spec import models
from test_torch_spec_mq import mq_trace, scan_traces


@pytest.mark.parametrize("spec_depth,page_size,granularity", [
    (2, 8, "token"), (2, 8, "page")])
def test_mq_verify_equals_scan_with_model_drafts(models, scan_traces, spec_depth,
                                                 page_size, granularity):
    """tests/test_mq_verify.py's pin: a cold and a warm row, drafts from
    the target model itself; mq (and mq at page granularity) against scan
    at token granularity."""
    assert (mq_trace(models, spec_depth, page_size, "mq", granularity)
            == scan_traces(spec_depth, page_size))
