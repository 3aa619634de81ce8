"""The benchmark's cell runners, generator, trace reader and comparisons."""
