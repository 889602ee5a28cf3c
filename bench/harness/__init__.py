"""The benchmark harness: manifest, data, records, spans and trace, peaks."""
