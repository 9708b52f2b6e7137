"""Fleet fabric (port of ``analytics_zoo_tpu.serving.fabric``).

Only the result-tree codec of :mod:`.coopcache` is ported, because the
HTTP layer's cooperative-cache peek (``GET /v1/cache/<key>``) answers with
it. Membership, the fleet door, the peer cache client and the autoscaler
wait for the multi-host serving tier (ROADMAP A8).
"""
