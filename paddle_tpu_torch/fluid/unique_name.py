"""Unique name generator (copy of ``paddle_tpu/fluid/unique_name.py``;
reference: python/paddle/fluid/unique_name.py).

Names are ``prefix_N`` with a per-prefix counter held by a switchable
generator, so cloned/re-built programs get deterministic names.
"""

from __future__ import annotations

import contextlib


class UniqueNameGenerator(object):
    def __init__(self, prefix=None):
        self.ids = {}
        self.prefix = prefix or ""

    def __call__(self, key):
        tmp = self.ids.setdefault(key, 0)
        self.ids[key] = tmp + 1
        return self.prefix + "_".join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


def switch(new_generator=None):
    global generator
    old = generator
    generator = new_generator or UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)


def generate_with_ignorable_key(key):
    """reference: unique_name.py generate_with_ignorable_key — dygraph
    name generation that may ignore the structural key; same stream as
    generate() here."""
    return generate(key)
