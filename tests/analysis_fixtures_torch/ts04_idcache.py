"""TS04 — id()-keyed identity (the cache-aliasing bug class).

Applies to host code too: an id-keyed cache corrupts solves from
outside any trace.
"""

_CACHE = {}


def cached_view(graph, build):
    key = id(graph)  # expect: TS04
    if key not in _CACHE:
        _CACHE[key] = build(graph)
    return _CACHE[key]


def store_by_id(registry, obj):
    registry[id(obj)] = obj  # expect: TS04
    return registry


def identity_comparison(a, b):
    # comparing identities directly is not caching — quiet
    return id(a) == id(b)


def stable_key_cache(graph, build):
    # the sanctioned pattern: key on a version/shape token the object
    # carries, not on its memory address
    key = (graph.version, graph.n)
    if key not in _CACHE:
        _CACHE[key] = build(graph)
    return _CACHE[key]
