"""Composable reader decorators (port of ``paddle_tpu/reader``;
reference: python/paddle/reader/)."""

from .decorator import (  # noqa: F401
    map_readers,
    buffered,
    compose,
    chain,
    shuffle,
    ComposeNotAligned,
    firstn,
    xmap_readers,
    cache,
    multiprocess_reader,
    batch,
)
