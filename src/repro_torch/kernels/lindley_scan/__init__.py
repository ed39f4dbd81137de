"""Batched FCFS station departures: k = 1 (Lindley recursion) and k servers."""
