"""Distribution: the sharding rules of the serving mesh."""
