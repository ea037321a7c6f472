"""On-device DGI modules of the port: group management (:mod:`.gm`),
load balancing (:mod:`.lb`), state collection (:mod:`.sc`) and gradient
Volt-VAR control (:mod:`.vvc`)."""
