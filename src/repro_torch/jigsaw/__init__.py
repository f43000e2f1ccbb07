"""The JigSaw scheduler's side of the port: the task cost model the depth
policies read."""
