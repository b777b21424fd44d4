"""Distribution: sharding rules, compressed collectives, pipeline (``repro/parallel``)."""
