"""Dashboard internationalization.

Parity: the reference serves key=value message bundles per language from
`deeplearning4j-play/src/main/resources/dl4j_i18n/` (train.overview.*,
train.model.*, ... in de/en/ja/ko/ru/zh; DefaultI18N.java resolves them).
The port's copy of the JAX package's `ui/i18n.py` (no framework in it).

Here the catalog is an in-module dict served as JSON at /i18n?lang=xx;
pages mark translatable nodes with data-i18n attributes and apply the
catalog client-side. Unknown languages/keys fall back to English."""
from __future__ import annotations

from typing import Dict

LANGUAGES = ("en", "de", "ja", "ko", "ru", "zh")

# key -> {lang: text}; keys mirror the reference's naming scheme
_CATALOG: Dict[str, Dict[str, str]] = {
    "train.nav.overview": {
        "en": "overview", "de": "Übersicht", "ja": "概要", "ko": "개요",
        "ru": "обзор", "zh": "概览"},
    "train.nav.model": {
        "en": "model", "de": "Modell", "ja": "モデル", "ko": "모델",
        "ru": "модель", "zh": "模型"},
    "train.nav.system": {
        "en": "system", "de": "System", "ja": "システム", "ko": "시스템",
        "ru": "система", "zh": "系统"},
    "train.nav.tsne": {
        "en": "t-SNE", "de": "t-SNE", "ja": "t-SNE", "ko": "t-SNE",
        "ru": "t-SNE", "zh": "t-SNE"},
    "train.nav.word2vec": {
        "en": "word2vec", "de": "word2vec", "ja": "word2vec",
        "ko": "word2vec", "ru": "word2vec", "zh": "word2vec"},
    "train.overview.chart.score": {
        "en": "Score vs iteration", "de": "Score je Iteration",
        "ja": "スコア対イテレーション", "ko": "반복 당 점수",
        "ru": "Оценка по итерациям", "zh": "得分随迭代变化"},
    "train.overview.chart.throughput": {
        "en": "Samples/sec", "de": "Beispiele/Sek.", "ja": "サンプル/秒",
        "ko": "샘플/초", "ru": "примеров/сек", "zh": "样本/秒"},
    "train.overview.chart.memory": {
        "en": "Device memory (MB in use)",
        "de": "Gerätespeicher (MB belegt)", "ja": "デバイスメモリ (使用MB)",
        "ko": "장치 메모리 (사용 MB)", "ru": "Память устройства (МБ)",
        "zh": "设备内存（已用MB）"},
    "train.overview.chart.paramMag": {
        "en": "Parameter mean magnitudes (log10)",
        "de": "Mittlere Parameterbeträge (log10)",
        "ja": "パラメータ平均絶対値 (log10)",
        "ko": "파라미터 평균 크기 (log10)",
        "ru": "Средние величины параметров (log10)",
        "zh": "参数平均幅值 (log10)"},
    "train.overview.chart.ratio": {
        "en": "Update:param ratio (log10, healthy ~ -3)",
        "de": "Update:Parameter-Verhältnis (log10, gesund ~ -3)",
        "ja": "更新:パラメータ比 (log10, 健全 ~ -3)",
        "ko": "업데이트:파라미터 비율 (log10, 정상 ~ -3)",
        "ru": "Отношение обновл.:парам. (log10, норма ~ -3)",
        "zh": "更新:参数比 (log10, 健康值 ~ -3)"},
    "train.overview.info": {
        "en": "Model / session info", "de": "Modell-/Sitzungsinfo",
        "ja": "モデル / セッション情報", "ko": "모델 / 세션 정보",
        "ru": "Информация о модели/сессии", "zh": "模型 / 会话信息"},
    "train.overview.chart.gradHist": {
        "en": "Last gradient histogram", "de": "Letztes Gradienten-Histogramm",
        "ja": "最新の勾配ヒストグラム", "ko": "최근 그래디언트 히스토그램",
        "ru": "Гистограмма градиентов", "zh": "最新梯度直方图"},
    "train.model.layers": {
        "en": "Layers (click to select)",
        "de": "Schichten (zum Auswählen klicken)",
        "ja": "レイヤー (クリックで選択)", "ko": "레이어 (클릭하여 선택)",
        "ru": "Слои (щёлкните для выбора)", "zh": "层（点击选择）"},
    "train.model.paramMag": {
        "en": "Mean magnitude: parameters (log10)",
        "de": "Mittlerer Betrag: Parameter (log10)",
        "ja": "平均絶対値: パラメータ (log10)",
        "ko": "평균 크기: 파라미터 (log10)",
        "ru": "Средняя величина: параметры (log10)",
        "zh": "平均幅值：参数 (log10)"},
    "train.model.gradMag": {
        "en": "Mean magnitude: gradients (log10)",
        "de": "Mittlerer Betrag: Gradienten (log10)",
        "ja": "平均絶対値: 勾配 (log10)", "ko": "평균 크기: 그래디언트 (log10)",
        "ru": "Средняя величина: градиенты (log10)",
        "zh": "平均幅值：梯度 (log10)"},
    "tsne.title": {
        "en": "t-SNE embedding", "de": "t-SNE-Einbettung", "ja": "t-SNE埋め込み",
        "ko": "t-SNE 임베딩", "ru": "t-SNE вложение", "zh": "t-SNE嵌入"},
    "word2vec.title": {
        "en": "Nearest words", "de": "Nächste Wörter", "ja": "近傍単語",
        "ko": "가장 가까운 단어", "ru": "Ближайшие слова", "zh": "最近的词"},
    "word2vec.prompt": {
        "en": "word", "de": "Wort", "ja": "単語", "ko": "단어",
        "ru": "слово", "zh": "词"},
}


def tr(key: str, lang: str = "en") -> str:
    entry = _CATALOG.get(key, {})
    return entry.get(lang, entry.get("en", key))


def catalog(lang: str = "en") -> Dict[str, str]:
    lang = lang if lang in LANGUAGES else "en"
    return {k: tr(k, lang) for k in _CATALOG}
