"""Running the port on several cards: process groups and the (dp, fsdp, sp)
mesh with the FSDP sharding rules (``mesh``), Ulysses sequence parallelism
for the bidirectional model (``sequence``) and for the cached causal decode
(``decode_sp``)."""
