"""Host-side graph generators, seed selection and neighbour sampling; the
synthetic token and user-behaviour streams."""
