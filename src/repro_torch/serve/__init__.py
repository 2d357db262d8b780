"""Paged serving: KV pools, scheduler, continuous-batching engine."""
