"""Policy serving: the solo engine and the fleet."""
