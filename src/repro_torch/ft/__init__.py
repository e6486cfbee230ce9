"""Fault tolerance: the straggler monitor the serving scheduler heartbeats
into (`elastic`)."""
