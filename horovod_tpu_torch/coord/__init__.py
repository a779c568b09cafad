"""The host coordination plane: name-keyed negotiation of the eager
collectives at a rank-0 coordinator (``csrc/coordinator.cc``, built by
:mod:`._build`), with cross-rank validation, response fusion, stall
detection, the timeline and the heartbeat abort. :mod:`.client` is its
binding; ``runtime.init`` brings it up in a coordinated world."""
