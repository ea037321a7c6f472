"""Query serving: admission, micro-batching, the pf engine, HTTP."""
