"""Host-side helpers of the port: prompt templates, numerics debugging
(`debug`) and profiling (`profiling`)."""
