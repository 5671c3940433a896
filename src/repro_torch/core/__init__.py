"""Core collaboration library, serving slice: uncertainty, routing,
policies, semantic cache, paged KV, sequence state, speculation, scheduler,
and the per-request engine."""
