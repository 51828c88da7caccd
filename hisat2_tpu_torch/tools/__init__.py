# ecosystem tools: GTF extractors, variant extractors, read simulator
