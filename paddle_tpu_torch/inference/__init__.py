"""Serving on the port.

As in the JAX package, the serving modules are imported by their path,
not re-exported here: ``from paddle_tpu_torch.inference.serving import
ServingEngine``, ``.scheduler`` (``OnlineScheduler``, ``SLOScheduler``,
``Arrival``), ``.prefix_cache`` (``PrefixCache``, ``PagedPrefixCache``,
``make_prefix_cache``), ``.paged_kv`` (``PagedKVCache``), ``.kv_tiers``
(``HostTier``), ``.fleet`` (``FleetRouter``, ``build_fleet``,
``CacheDirectory``, ``FaultInjector``, ``ReplicaCrash``,
``ReplicaHang``, ``Shadow``, ``FleetReport``) and ``.disagg``
(``DisaggRouter``)."""
