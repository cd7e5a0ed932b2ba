from repro_torch.metrics.bleu import corpus_bleu, strip_special, token_accuracy

__all__ = ["corpus_bleu", "strip_special", "token_accuracy"]
