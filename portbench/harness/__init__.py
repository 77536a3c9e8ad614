"""The benchmark's yardstick: manifest, inputs, drivers, counts, results."""
