"""Plain float64 references that the port's models are held to; they import
neither package of the repo."""
