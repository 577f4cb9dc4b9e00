"""Problem IR, transcription and structure detection."""
